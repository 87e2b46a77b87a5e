"""The trace-to-stage reduction of benchmarks/trace_stages.py: the bytes
each launch moves, the named-scope stage map and the stage table (the GPU
trace itself needs a card; these parts do not)."""

import jax
import jax.numpy as jnp
import pytest

from benchmarks import trace_stages

# One launch of each kind the byte model tells apart.
MODULE = """\
HloModule m, entry_computation_layout={(f32[8,16]{1,0})->f32[8,16]{1,0}}

%fused_mul (param_0: f32[8,16], param_1: f32[8,16]) -> f32[8,16] {
  %param_0 = f32[8,16]{1,0} parameter(0)
  %param_1 = f32[8,16]{1,0} parameter(1)
  %sine = f32[8,16]{1,0} sine(%param_0)
  ROOT %multiply = f32[8,16]{1,0} multiply(%sine, %param_1), metadata={op_name="jit(f)/flood/mul"}
}

%fused_dus (param_0.5: f32[128,64], param_1.9: f32[128,64], param_2.12: s32[]) -> f32[128,64] {
  %param_0.5 = f32[128,64]{1,0} parameter(0)
  %param_1.9 = f32[128,64]{1,0} parameter(1)
  %param_2.12 = s32[] parameter(2)
  %constant.27 = s32[] constant(0)
  %dynamic_slice.10 = f32[1,64]{1,0} dynamic-slice(%param_1.9, %param_2.12, %constant.27), dynamic_slice_sizes={1,64}
  %bitcast.3 = f32[64,1]{0,1} bitcast(%dynamic_slice.10)
  %bitcast.4 = f32[1,64]{1,0} bitcast(%bitcast.3)
  %sin.5 = f32[1,64]{1,0} sine(%bitcast.4)
  ROOT %dus = f32[128,64]{1,0} dynamic-update-slice(%param_0.5, %sin.5, %param_2.12, %constant.27)
}

%add_f32 (lhs: f32[], rhs: f32[]) -> f32[] {
  %lhs = f32[] parameter(0)
  %rhs = f32[] parameter(1)
  ROOT %add = f32[] add(%lhs, %rhs)
}

%fused_scatter (param_0.1: f32[1000], param_1.1: s32[5,1], param_2.1: f32[5]) -> f32[1000] {
  %param_0.1 = f32[1000]{0} parameter(0)
  %param_1.1 = s32[5,1]{1,0} parameter(1)
  %param_2.1 = f32[5]{0} parameter(2)
  ROOT %scatter = f32[1000]{0} scatter(%param_0.1, %param_1.1, %param_2.1), update_window_dims={}, inserted_window_dims={0}, scatter_dims_to_operand_dims={0}, index_vector_dim=1, to_apply=%add_f32
}

ENTRY %main (x: f32[8,16], buf: f32[128,64], k: s32[], a: f32[4,300], b: f32[300,10], acc: f32[1000], idx: s32[5,1], upd: f32[5]) -> f32[8,16] {
  %x = f32[8,16]{1,0} parameter(0)
  %buf = f32[128,64]{1,0} parameter(1)
  %k = s32[] parameter(2)
  %a = f32[4,300]{1,0} parameter(3)
  %b = f32[300,10]{1,0} parameter(4)
  %acc = f32[1000]{0} parameter(5)
  %idx = s32[5,1]{1,0} parameter(6)
  %upd = f32[5]{0} parameter(7)
  %dus_fusion = f32[128,64]{1,0} fusion(%buf, %buf, %k), kind=kLoop, calls=%fused_dus
  %gemm = (f32[4,10]{1,0}, s8[1024]{0}) custom-call(%a, %b), custom_call_target="__cublas$gemm"
  %scatter_fusion = f32[1000]{0} fusion(%acc, %idx, %upd), kind=kInput, calls=%fused_scatter
  ROOT %mul_fusion = f32[8,16]{1,0} fusion(%x, %x), kind=kLoop, calls=%fused_mul, metadata={op_name="jit(f)/flood/mul"}
}
"""


@pytest.mark.parametrize("op_name, stage", [
    ("jit(f)/vmap(grow)/closure_epochs/while/body/flood/while/body/or",
     "flood"),
    ("jit(f)/vmap(grow)/closure_epochs/while/body/reduce_min",
     "closure_epochs"),
    ("jit(f)/vmap(normals)/while/body/closed_call/select_n", "normals"),
    ("jit(f)/cluster/ccl/while/body/min", "ccl"),
    ("jit(f)/grow/jit(flood_fill_static)/pad", "grow"),
    ("jit(f)/transpose", "other"),
])
def test_stage_of_innermost_scope(op_name, stage):
    assert trace_stages.stage_of(op_name) == stage


def test_parse_hlo_counts_operand_and_output_bytes():
    def f(x, y):
        with jax.named_scope("flood"):
            return jnp.sin(x) * y

    x = jnp.ones((8, 16), jnp.float32)
    text = jax.jit(f).lower(x, x).compile().as_text()
    hlo = trace_stages.parse_hlo(text)
    flood = [b for b, op in hlo.values()
             if trace_stages.stage_of(op) == "flood"]
    # the kernel reads two [8, 16] f32 operands and writes one
    assert max(flood) == 3 * 8 * 16 * 4
    assert trace_stages.shape_bytes("(f32[2,3]{1,0}, u8[5]{0})") == 29


@pytest.mark.parametrize("launch, nbytes", [
    # elementwise: both operands and the result in full
    ("mul_fusion", 3 * 8 * 16 * 4),
    # in-place row update: reads one row of the source and the index,
    # writes one row; nothing of the updated buffer is read
    ("dus_fusion", 64 * 4 + 4 + 64 * 4),
    # cuBLAS: both matrices and the product, not the scratch space
    ("gemm", 4 * 300 * 4 + 300 * 10 * 4 + 4 * 10 * 4),
    # in-place scatter: indices and updates read, updates written
    ("scatter_fusion", 5 * 4 + 5 * 4 + 5 * 4),
])
def test_parse_hlo_launch_bytes(launch, nbytes):
    hlo = trace_stages.parse_hlo(MODULE)
    assert hlo[launch][0] == nbytes
    # instructions inside fused computations launch nothing
    assert "dynamic_slice.10" not in hlo and "scatter" not in hlo


def test_stage_rows_refuse_a_ratio_above_the_hbm_rate():
    rows = trace_stages.stage_rows(
        {"near": {"ns": 1000, "launches": 2, "bytes": 10**6},
         "fast": {"ns": 100, "launches": 1, "bytes": 10**6}}, 1e12)
    assert [r["stage"] for r in rows] == ["near", "fast"]
    near, fast = rows
    assert near["times_off_bound"] == pytest.approx(1.0)
    assert not near["above_hbm_rate"] and near["us_per_launch"] == 0.5
    assert fast["above_hbm_rate"] and fast["times_off_bound"] is None
