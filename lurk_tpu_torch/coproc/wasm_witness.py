"""circom witness calculator over the wasm interpreter.

The port's own copy of the JAX package's ``coproc/wasm_witness.py``:
host Python, no torch. Implements the circom 2.x witness-calculator
host protocol (the wasm module exports init/setInputSignal/getWitness/...
and a 32-bit shared read-write buffer; signals are addressed by the
64-bit FNV-1a hash of their name). Functional parity with circom's
witness_calculator.js as used by the reference's circom-scotia
dependency (reference src/coprocessor/circom/mod.rs:9-51).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .wasm_interp import Instance, WasmError, parse_module


def fnv1a_64(name: str) -> int:
    h = 0xCBF29CE484222325
    for ch in name:
        h ^= ord(ch)
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class CircomWasmError(WasmError):
    pass


class WitnessCalculator:
    """One loaded circom witness-calculator wasm module."""

    def __init__(self, wasm_bytes: bytes):
        self._messages: List[str] = []
        self._msg_buf: List[int] = []

        def exception_handler(code=0):
            names = {1: "signal not found", 2: "too many signals set",
                     3: "signal already set",
                     4: "assert failed", 5: "not enough signals set"}
            msg = "; ".join(self._messages) or names.get(
                code, f"error {code}")
            raise CircomWasmError(f"circom witness calculator: {msg}")

        def log(*args):
            return None

        imports = {
            ("runtime", "exceptionHandler"): exception_handler,
            ("runtime", "printErrorMessage"): self._flush_message,
            ("runtime", "writeBufferMessage"): self._buffer_message,
            ("runtime", "showSharedRWMemory"): log,
            ("runtime", "log"): log,
            ("runtime", "logGetSignal"): log,
            ("runtime", "logSetSignal"): log,
            ("runtime", "logStartComponent"): log,
            ("runtime", "logFinishComponent"): log,
        }
        self.inst = Instance(parse_module(wasm_bytes), imports)
        ex = self.inst.export
        self._init = ex("init")
        self._get_n32 = ex("getFieldNumLen32")
        self._get_raw_prime = ex("getRawPrime")
        self._read_shared = ex("readSharedRWMemory")
        self._write_shared = ex("writeSharedRWMemory")
        self._set_input = ex("setInputSignal")
        self._get_witness_size = ex("getWitnessSize")
        self._get_witness = ex("getWitness")
        self.n32 = self._get_n32()
        self._get_raw_prime()
        self.prime = self._read_big()

    # -- runtime message imports ---------------------------------------------

    def _buffer_message(self, *args):
        # chars arrive via the shared buffer; collect printable bytes
        chars = []
        for j in range(self.n32 if hasattr(self, "n32") else 8):
            try:
                v = self._read_shared(j)
            except Exception:
                break
            for k in range(4):
                c = (v >> (8 * k)) & 0xFF
                if c:
                    chars.append(chr(c))
        if chars:
            self._msg_buf.append("".join(chars))
        return None

    def _flush_message(self, *args):
        if self._msg_buf:
            self._messages.append("".join(self._msg_buf))
            self._msg_buf = []
        return None

    # -- helpers ---------------------------------------------------------------

    def _read_big(self) -> int:
        v = 0
        for j in range(self.n32):
            v |= (self._read_shared(j) & 0xFFFFFFFF) << (32 * j)
        return v

    def _write_big(self, v: int) -> None:
        for j in range(self.n32):
            self._write_shared(j, (v >> (32 * j)) & 0xFFFFFFFF)

    # -- the protocol ------------------------------------------------------------

    def calculate_witness(self, inputs: Dict[str, Sequence[int]],
                          sanity_check: bool = False) -> List[int]:
        self._messages = []
        self._init(1 if sanity_check else 0)
        for name, values in inputs.items():
            h = fnv1a_64(name)
            msb, lsb = h >> 32, h & 0xFFFFFFFF
            if isinstance(values, int):
                values = [values]
            for i, v in enumerate(values):
                self._write_big(int(v) % self.prime)
                self._set_input(msb, lsb, i)
        n = self._get_witness_size()
        out = []
        for i in range(n):
            self._get_witness(i)
            out.append(self._read_big())
        return out


def load_witness_calculator(path) -> WitnessCalculator:
    with open(path, "rb") as fh:
        return WitnessCalculator(fh.read())
