"""The benchmark of tpu_ec_torch on one NVIDIA H100: ``python3 benchmark/run.py``.

See ``benchmark/README.md``.  Nothing under this directory imports jax or
tpu_ec; ``benchmark/reference`` imports nothing of tpu_ec_torch either.
"""
