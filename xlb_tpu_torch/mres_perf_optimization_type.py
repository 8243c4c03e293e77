"""Multires strategy enum and its command-line option -- the port's own
copy of ``xlb_tpu.mres_perf_optimization_type``.

- NAIVE_COLLIDE_STREAM: the TORCH tier on every level (plain torch ops).
- FUSION_AT_FINEST: the CUDA tier's fused routes -- the finest level's two
  sub-steps in one pass of the collide-then-stream pair kernel, the
  coarsest and BC-less middle levels in single-sub-step passes of the same
  kernel family.
- FUSION_AT_FINEST_SFV / _SFV_ALL: the same, and every coarser level's
  per-level collide through the collide-only kernel where the TORCH tier
  would run it. Both names map to this all-level fusion.
"""

import argparse
from enum import Enum


class MresPerfOptimizationType(Enum):
    NAIVE_COLLIDE_STREAM = "naive_collide_stream"
    FUSION_AT_FINEST = "fusion_at_finest"
    FUSION_AT_FINEST_SFV = "fusion_at_finest_sfv"
    FUSION_AT_FINEST_SFV_ALL = "fusion_at_finest_sfv_all"

    @classmethod
    def from_string(cls, name: str) -> "MresPerfOptimizationType":
        try:
            return cls(name.lower())
        except ValueError:
            valid = ", ".join(m.value for m in cls)
            raise ValueError(f"unknown multires optimization {name!r}; choose from: {valid}") from None

    @staticmethod
    def build_arg_parser(parser: argparse.ArgumentParser = None) -> argparse.ArgumentParser:
        parser = parser or argparse.ArgumentParser()
        parser.add_argument(
            "--mres-perf-optimization",
            type=str,
            default=MresPerfOptimizationType.FUSION_AT_FINEST.value,
            choices=[m.value for m in MresPerfOptimizationType],
            help="multires kernel-fusion strategy",
        )
        return parser
