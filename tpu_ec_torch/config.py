"""Typed configuration for the PyTorch/CUDA port.

One dataclass initialised from ``TPU_EC_TORCH_*`` environment variables.

==========================  ================================  ======================
field                        env var                           consumed by
==========================  ================================  ======================
cache                        TPU_EC_TORCH_CACHE                ops/ntt_digit tables
cache_dir                    TPU_EC_TORCH_CACHE_DIR            ops/ntt_digit tables
native_build_dir             TPU_EC_TORCH_BUILD_DIR            native, kernels/build
ntt_digit_leaf_log           TPU_EC_TORCH_NTT_DIGIT_LEAF_LOG   ops/ntt_digit
ntt_impl                     TPU_EC_TORCH_NTT_IMPL             ops/ntt (log_n >= 10)
ntt_leaf_log                 TPU_EC_TORCH_NTT_LEAF_LOG         ops/ntt_fused
msm_window                   TPU_EC_TORCH_MSM_WINDOW           ops/msm (None = auto)
msm_hbm_budget_bytes         TPU_EC_TORCH_HBM_BUDGET           ops/msm.device_budget_bytes
num_threads                  TPU_EC_TORCH_NUM_THREADS          utils/threadpool
timer                        TPU_EC_TORCH_TIMER                utils/timer
min_devices                  TPU_EC_TORCH_MIN_DEVICES          parallel/mesh policy
dist_msm_accum               TPU_EC_TORCH_DIST_MSM_ACCUM       parallel/msm_dist
log_level                    TPU_EC_TORCH_LOG                  get_logger
==========================  ================================  ======================

``get_config()`` returns the process-wide instance; set its fields to
change it at run time.

Everything that is built at run time (the CUDA kernels, the native C++
library, the digit-NTT tables) lands under one directory,
``tpu_ec_torch/_build`` unless ``native_build_dir`` says otherwise.
"""

from __future__ import annotations

import dataclasses
import logging
import os

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
NTT_LEAF_LOG_DEFAULT = 8


def _env_int(name: str, default: int | None) -> int | None:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v not in ("0", "false", "False", "no")


@dataclasses.dataclass
class Config:
    """All runtime knobs.  ``Config.from_env()`` is the default instance."""

    # disk cache of the digit-NTT constant tables
    cache: bool = True
    cache_dir: str | None = None
    # where the kernels, the native library and the tables are built
    native_build_dir: str | None = None
    # digit-matmul NTT max leaf radix log2; bounded by the int32 accumulator
    # (m * 37 * 127^2 < 2^31 -> leaf <= 11)
    ntt_digit_leaf_log: int = 8
    # NTT route for log_n >= 10: "digit" (int8 leaf GEMMs + K2,
    # ops/ntt_digit.py) or "fused" (block-resident leaf NTTs, kernel K4,
    # ops/ntt_fused.py); both give the same values
    ntt_impl: str = "digit"
    # fused-NTT leaf radix log2 (kernel K4 holds 2^leaf elements a block;
    # at most 10)
    ntt_leaf_log: int = NTT_LEAF_LOG_DEFAULT
    # MSM window bits; None = analytic model (msm_pair.default_window_size_pair)
    msm_window: int | None = None
    # device-memory budget for MSM chunk sizing; None = the free memory the
    # card reports (torch.cuda.mem_get_info), or 4 GiB on the CPU
    msm_hbm_budget_bytes: int | None = None
    # host worker pool size (utils/threadpool); 0 = the CPU count
    num_threads: int = 0
    # per-span host and device timing (utils/timer: timer.report()), off by
    # default; the spans reach a torch profiler whether or not it is on
    timer: bool = False
    # the fewest devices make_mesh may degrade to before it raises
    min_devices: int = 1
    # bucket accumulation of the distributed MSM on each rank: "pair" (the
    # pair engine, ops/msm_pair.py) or "scan" (ops/msm_scan.py, ~log2(n)
    # times the adds).  tpu_ec defaults to "scan" for its XLA-CPU compile
    # time only; the port compiles nothing per shape
    dist_msm_accum: str = "pair"
    log_level: str = "WARNING"

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            cache=_env_bool("TPU_EC_TORCH_CACHE", True),
            cache_dir=os.environ.get("TPU_EC_TORCH_CACHE_DIR") or None,
            native_build_dir=os.environ.get("TPU_EC_TORCH_BUILD_DIR") or None,
            ntt_digit_leaf_log=_env_int("TPU_EC_TORCH_NTT_DIGIT_LEAF_LOG", 8) or 8,
            ntt_impl=os.environ.get("TPU_EC_TORCH_NTT_IMPL") or "digit",
            ntt_leaf_log=_env_int("TPU_EC_TORCH_NTT_LEAF_LOG", None) or NTT_LEAF_LOG_DEFAULT,
            msm_window=_env_int("TPU_EC_TORCH_MSM_WINDOW", None),
            msm_hbm_budget_bytes=_env_int("TPU_EC_TORCH_HBM_BUDGET", None),
            num_threads=_env_int("TPU_EC_TORCH_NUM_THREADS", 0) or 0,
            timer=_env_bool("TPU_EC_TORCH_TIMER", False),
            min_devices=_env_int("TPU_EC_TORCH_MIN_DEVICES", 1) or 1,
            dist_msm_accum=os.environ.get("TPU_EC_TORCH_DIST_MSM_ACCUM") or "pair",
            log_level=os.environ.get("TPU_EC_TORCH_LOG", "WARNING"),
        )

    def build_dir(self, *parts: str) -> str:
        """A directory under the build root, created on first use."""
        root = self.native_build_dir or os.path.join(_PKG_DIR, "_build")
        d = os.path.abspath(os.path.join(root, *parts))
        os.makedirs(d, exist_ok=True)
        return d


_config: Config | None = None


def get_config() -> Config:
    """The process-wide config (lazily initialised from the environment)."""
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def get_logger(name: str) -> logging.Logger:
    """A library logger at the configured level."""
    log = logging.getLogger(name)
    log.setLevel(get_config().log_level.upper())
    return log
