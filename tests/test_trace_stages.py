"""The trace reduction of ``benches/trace_stages.py``, checked on the CPU:
HLO ops map to the encoder's stages, and device events sum per stage."""

import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "benches"))

import trace_stages as ts  # noqa: E402
from gzp_tpu import Gzip, ParCompress  # noqa: E402


@pytest.fixture(scope="module")
def stages():
    w = ParCompress(Gzip, io.BytesIO(), num_threads=2, compression_level=6,
                    buffer_size=32768)
    arr = np.zeros((2, 32768), np.uint8)
    lengths = np.full(2, 32768, np.int32)
    halo, dict_lens = w._make_halo(arr, lengths)
    args = [jnp.asarray(x) for x in (arr, lengths, np.zeros(2, bool), halo, dict_lens)]
    out = ts.op_stages(w._encoder.lower(*args).compile().as_text())
    w.finish()
    return out


def test_every_stage_has_ops(stages):
    seen = {stage for stage, _ in stages.values()}
    assert set(ts.STAGES) <= seen
    assert any(is_sort and stage == "match" for stage, is_sort in stages.values())
    assert any(is_sort and stage == "pack" for stage, is_sort in stages.values())


def test_reduce_sums_per_stage():
    stages = {"a": ("match", True), "b": ("match", False), "c": ("pack", False)}
    events = [("a", 3_000_000, {}), ("a", 1_000_000, {}), ("b", 500_000, {}),
              ("c", 250_000, {}), ("zz", 1_000, {})]
    r = ts.reduce_trace(events, stages)
    assert r["device_ms"] == pytest.approx(4.751)
    assert r["stage_ms"] == pytest.approx({"match": 4.5, "pack": 0.25, "other": 0.001})
    assert r["sort_ms"] == pytest.approx({"match": 4.0})
    assert r["top10"][0] == {"op": "a", "stage": "match", "ms": 4.0, "launches": 2}


# the shapes of XLA:GPU's sort ops in a compiled module's text
_GPU_HLO = """\
%fused_computation.3 (param_0.3: u32[4,8]) -> (u32[4,8], s32[4,8]) {
  %iota.1 = s32[4,8]{1,0} iota(), iota_dimension=1
  ROOT %sort.2 = (u32[4,8]{1,0}, s32[4,8]{1,0}) sort(%param_0.3, %iota.1), dimensions={1}, to_apply=%cmp
}

%fused_add (p0: u32[4,8]) -> u32[4,8] {
  ROOT %add.1 = u32[4,8]{1,0} add(%p0, %p0)
}

ENTRY %main.1 (Arg_0.1: u32[4,8]) -> u32[4,8] {
  %fusion.18 = (u32[4,8]{1,0}, s32[4,8]{1,0}) fusion(%Arg_0.1), kind=kCustom, calls=%fused_computation.3, metadata={op_name="jit(run)/match/sort"}
  %custom-call.3 = (u32[4,8]{1,0}, u8[64]{0}) custom-call(%Arg_0.1), custom_call_target="__cub$DeviceRadixSort", metadata={op_name="jit(run)/emit/pack/sort"}
  %loop_add_fusion = u32[4,8]{1,0} fusion(%Arg_0.1), kind=kLoop, calls=%fused_add, metadata={op_name="jit(run)/match/add"}
  %gemm_fusion.1 = f32[4,8]{1,0} custom-call(%Arg_0.1), custom_call_target="__cublas$gemm", metadata={op_name="jit(run)/emit/dot_general"}
  ROOT %sort.9 = u32[4,8]{1,0} sort(%Arg_0.1), dimensions={1}, to_apply=%cmp, metadata={op_name="jit(run)/compact/sort"}
}
"""


@pytest.mark.parametrize("op,want", [
    ("fusion.18", ("match", True)),
    ("custom-call.3", ("pack", True)),
    ("loop_add_fusion", ("match", False)),
    ("gemm_fusion.1", ("emit", False)),
    ("sort.9", ("compact", True)),
])
def test_sort_ops_counted_alike(op, want):
    """A sort counts as one whether XLA fused it, CUB runs it, or it
    stands alone, at every stage."""
    assert ts.op_stages(_GPU_HLO)[op] == want
