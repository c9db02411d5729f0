"""The benchmark's plain reference: Python integers and NumPy only.

Nothing here imports the program (``lurk_tpu_torch``), JAX or the JAX
package; every constant is worked out again from its public definition.
"""
