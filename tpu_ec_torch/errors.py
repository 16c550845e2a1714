"""Error types (parity with ec-gpu-program/src/lib.rs:10-32 EcError)."""


class EcError(Exception):
    """Base error for tpu_ec_torch operations."""


class Aborted(EcError):
    """Cooperative abort requested via a maybe_abort hook
    (fft.rs:25-27, multiexp.rs:140-144 parity)."""


class DeviceError(EcError):
    """Underlying runtime/device failure."""
