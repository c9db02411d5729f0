"""Coprocessors: the sha256 and trie coprocessors and the gadgets a
coprocessor circuit builds Lurk data with (the port of the JAX
package's ``coproc/``, part A)."""
