"""Coprocessors: the sha256, trie and circom coprocessors, the gadgets a
coprocessor circuit builds Lurk data with, and the wasm interpreter and
witness calculator of circom gadgets (the port of the JAX package's
``coproc/``)."""
