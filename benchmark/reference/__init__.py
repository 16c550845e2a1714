"""The plain reference: Python integers and plain PyTorch limb arithmetic.

Independent of the program under test: it imports nothing of tpu_ec_torch
(nor jax or tpu_ec), and works out again, from the benchmark's own inputs,
everything the program derives from them.
"""
