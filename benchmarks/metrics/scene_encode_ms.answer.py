"""Median device span of ``SceneCache.encode``, from the CUDA events the
loop records around each call in the window (ms)."""
from benchmarks.metrics._common import median_ms


def read(ctx):
    return median_ms(ctx.get("encode_ms"))
