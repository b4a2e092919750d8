"""The head-dim-split rows (``wgmma_dblk``: K1, K3 and K4 past D = 128)
against the scripts that run them on the card:
``chip_smoke.py``'s
large_d phase expects the rows the tables select, and the sweep of
``utils/bwd_tuning.py`` tries the compiled candidates that apply at each
head dim. CPU only: descriptors, rows and candidates, no kernel."""

import importlib.util
from pathlib import Path

import pytest

from mfa_tpu_torch.ops import params
from mfa_tpu_torch.ops.descriptors import (
    AttentionDescriptor,
    AttentionKernelType,
    head_dim_panels,
    launch_row,
    row_label,
)
from mfa_tpu_torch.utils import bwd_tuning

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_rows",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_large_d_phase_expects_the_tables_rows():
    """Every case of chip_smoke.py's large_d phase: the rows its K1, K3
    and K4 launches take from the tables (row_label: kernel and producer)
    are the ones large_d_rows expects (the head-dim-split kernels where
    TMA maps a bf16 row, their one CTA with its cp.async producer at D
    250; the first cut at D 300 and for fp32), and the
    phase runs all three on one CTA at D 192 and 256 (K1 also non-causal
    and with Gemma-2-9B's soft-cap and GQA) and on two past 256."""
    smoke = _chip_smoke()
    assert {(d, key, smoke.large_d_rows("bf16", d)[key])
            for d in (192, 256) for key in ("k1", "k3", "k4")} \
        == {(d, key, "wgmma_dblk") for d in (192, 256)
            for key in ("k1", "k3", "k4")}
    assert smoke.large_d_rows("bf16", 250) == {
        "k1": "wgmma_dblk/copy", "k3": "wgmma_dblk/copy",
        "k4": "wgmma_dblk/copy"}
    assert {c[0] for c in smoke.LARGE_D_CASES} >= {
        "causal_d192", "causal_d256", "noncausal_d256", "gqa_softcap50_d256"}
    for name, tag, d, n, hkv, opts in smoke.LARGE_D_CASES:
        desc = AttentionDescriptor(
            batch=1, num_q_heads=8, num_kv_heads=hkv, seq_len_q=n,
            seq_len_kv=n, head_dim=d, low_precision_inputs=tag == "bf16",
            low_precision_intermediates=tag == "bf16", **opts)
        want = smoke.large_d_rows(tag, d)
        for key, kind in zip(("k1", "k3", "k4"), AttentionKernelType):
            kd = desc.kernel_descriptor(kind)
            row = launch_row(kd, d, ())
            assert row_label(row) == want[key], (name, key)
            assert d <= row.block_d * head_dim_panels(row, d)
            if row.kernel == "wgmma_dblk":
                assert (head_dim_panels(row, d) == 1) == (d <= 256)


@pytest.mark.parametrize("name, d, want", [
    ("flash_fwd", 384, {(64, 32, 256, "mma_dblk"), (64, 64, 128, "mma_dblk"),
                        (128, 64, 128, "wgmma_dblk"),
                        (128, 64, 192, "wgmma_dblk"),
                        (128, 64, 256, "wgmma_dblk")}),
    ("flash_fwd", 512, {(64, 32, 256, "mma_dblk"), (64, 64, 128, "mma_dblk"),
                        (128, 64, 128, "wgmma_dblk"),
                        (128, 64, 256, "wgmma_dblk")}),
    ("flash_fwd", 300, {(64, 32, 256, "mma_dblk"),
                        (64, 64, 128, "mma_dblk")}),
    ("flash_fwd", 256, {(64, 32, 256, "mma"), (128, 64, 128, "wgmma_dblk"),
                        (128, 64, 192, "wgmma_dblk"),
                        (128, 64, 256, "wgmma_dblk"),
                        (128, 32, 256, "wgmma_dblk")}),
    ("flash_fwd", 192, {(64, 32, 256, "mma"), (128, 64, 128, "wgmma_dblk"),
                        (128, 64, 192, "wgmma_dblk"),
                        (128, 64, 256, "wgmma_dblk"),
                        (128, 32, 192, "wgmma_dblk"),
                        (128, 32, 256, "wgmma_dblk")}),
    ("flash_fwd", 136, {(64, 32, 256, "mma"), (128, 64, 128, "wgmma_dblk"),
                        (128, 64, 192, "wgmma_dblk"),
                        (128, 64, 256, "wgmma_dblk"),
                        (128, 32, 192, "wgmma_dblk"),
                        (128, 32, 256, "wgmma_dblk")}),
    ("flash_bwd_q", 384, {(64, 32, 256, "mma_dblk"),
                          (64, 64, 128, "mma_dblk"),
                          (128, 32, 192, "wgmma_dblk"),
                          (128, 32, 256, "wgmma_dblk")}),
    ("flash_bwd_q", 512, {(64, 32, 256, "mma_dblk"),
                          (64, 64, 128, "mma_dblk"),
                          (128, 32, 256, "wgmma_dblk")}),
    ("flash_bwd_q", 256, {(64, 32, 256, "mma"), (128, 32, 192, "wgmma_dblk"),
                          (128, 32, 256, "wgmma_dblk")}),
    ("flash_bwd_q", 192, {(64, 32, 256, "mma"), (128, 32, 192, "wgmma_dblk"),
                          (128, 32, 256, "wgmma_dblk")}),
    ("flash_bwd_q", 300, {(64, 32, 256, "mma_dblk"),
                          (64, 64, 128, "mma_dblk")}),
    ("flash_bwd_kv", 384, {(32, 64, 256, "mma_dblk"),
                           (32, 64, 128, "mma_dblk"),
                           (32, 64, 192, "wgmma_dblk"),
                           (32, 64, 256, "wgmma_dblk")}),
    ("flash_bwd_kv", 512, {(32, 64, 256, "mma_dblk"),
                           (32, 64, 128, "mma_dblk"),
                           (32, 64, 256, "wgmma_dblk")}),
    ("flash_bwd_kv", 256, {(32, 64, 256, "mma"), (32, 64, 192, "wgmma_dblk"),
                           (32, 64, 256, "wgmma_dblk")}),
    ("flash_bwd_kv", 192, {(32, 64, 256, "mma"), (32, 64, 192, "wgmma_dblk"),
                           (32, 64, 256, "wgmma_dblk")}),
])
def test_sweep_candidates_apply_where_their_kernel_runs(name, d, want):
    """bwd_tuning.dblk_candidates: past D = 256 the D-blocked first cut
    and the head-dim-split rows that cover D (one CTA, or clusters up to
    dblk_max_panels, K1's with 64-wide kv steps only; none for D % 8 !=
    0); at D 136-256 the mma rows and those split rows. Each candidate is
    a compiled row that fits one SM."""
    table = params.select_row(params.parameter_table(
        name, params.bf16_table_precision(d)), d)
    got = bwd_tuning.dblk_candidates(name, "bf16", d, table)
    assert set(got) == want and len(got) == len(want)
    in_bytes = 2
    for bq, bkv, bd, kernel in got:
        row = params.ParameterRow(d, bq, bkv, bd, kernel)
        assert params.smem_bytes(name, row, in_bytes) \
            <= params.H100.smem_per_block
        if kernel == "wgmma_dblk":
            least, most = bwd_tuning.panel_range(name, bd, bkv)
            assert least <= head_dim_panels(row, d) <= most \
                <= params.dblk_max_panels(bd)


def test_sweep_covers_the_tables_cluster_rows():
    """Every head-dim-split row the bf16 tables name is a candidate of the
    sweep at the shapes it covers (so the tables' figures come from it)."""
    for name in ("flash_fwd", "flash_bwd_q", "flash_bwd_kv"):
        rows = params.parameter_table(name, "bf16")
        for row in rows:
            if row.kernel != "wgmma_dblk":
                continue
            cands = bwd_tuning.dblk_candidates(name, "bf16", row.max_d, row)
            assert (row.block_q, row.block_kv, row.block_d,
                    row.kernel) in cands
            assert ("bf16", row.max_d, 4096) in bwd_tuning.DBLK_SHAPES


@pytest.mark.parametrize("variant", bwd_tuning.K1_SPLIT_VARIANTS,
                         ids=[v[0] for v in bwd_tuning.K1_SPLIT_VARIANTS])
def test_sweep_k1_variants_set_and_restore_the_launch(variant):
    """Each of the sweep's launch variants of K1's one-CTA rows gives the
    launch its rings and ping-pong (at D 256, block_kv 64: five tiles,
    the odd one in the V ring by the rule, in the K ring for k_deeper),
    and leaves the module's settings as they were."""
    name, most, pingpong, k_deeper = variant
    row = params.ParameterRow(256, 128, 64, 256, "wgmma_dblk")
    before = (params.FWD_RING_STAGES, params.FWD_PINGPONG, params.fwd_rings)
    rule = params.fwd_rings(row)
    assert rule == (2, 3)
    with bwd_tuning._k1_launch(variant):
        rings = params.fwd_rings(row)
        assert params.FWD_PINGPONG is pingpong
        assert params.smem_bytes("flash_fwd", row, 2) \
            <= params.H100.smem_per_block
    assert (params.FWD_RING_STAGES, params.FWD_PINGPONG,
            params.fwd_rings) == before
    want = {"rings2": (2, 2), "k_deeper": (3, 2)}.get(name, rule)
    assert rings == want


def test_k1_phase_expects_the_launch_rows():
    """chip_smoke.py's k1 phase past Llama-3-8B's shape: OpenLLaMA-3B's
    attention (D 100, MHA) at its prefill buckets and each of
    HEAD_DIM_CASES take the rows k1_row expects (D 100 and 250 on the
    wgmma kernel's cp.async producer, D 80, 96 by TMA, D 384 and 512 on
    the cluster, D 300, whose 600-byte rows TMA cannot map past D 256, on
    the D-blocked mma.sync row), and so do Llama-3-8B's operands with q
    8, 4 or 2 bytes off 16 (the copying producer, then mma.sync)."""
    import torch

    smoke = _chip_smoke()
    assert {c[1] for c in smoke.OPENLLAMA_K1_CASES} == {512, 2048}
    assert {bool(c[2]) for c in smoke.OPENLLAMA_K1_CASES} == {True, False}
    cases = [(100, 32, 32, 0) for _ in smoke.OPENLLAMA_K1_CASES]
    cases += [(d, 8 * g, 8, 0) for d, g in smoke.HEAD_DIM_CASES]
    cases += [(128, 32, 8, shift) for shift in smoke.K1_SHIFTS]
    labels = set()
    for d, hq, hkv, shift in cases:
        kd = AttentionDescriptor(
            batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=64,
            seq_len_kv=64, head_dim=d, causal=True,
            low_precision_inputs=True, low_precision_intermediates=True,
        ).kernel_descriptor(AttentionKernelType.FORWARD)
        buf = torch.zeros(64 * d + 8, dtype=torch.bfloat16)
        q = buf[shift // 2:shift // 2 + 64 * d].view(1, 64, d)
        kv = torch.zeros(1, 64, d, dtype=torch.bfloat16)
        label = row_label(launch_row(kd, d, (q, kv, kv)))
        assert label == smoke.k1_row(d, shift), (d, shift)
        labels.add(label)
    assert labels == {"wgmma", "wgmma/copy", "wgmma_dblk/copy",
                      "wgmma_dblk", "mma", "mma_dblk"}


def test_bwd_phase_expects_the_launch_rows():
    """chip_smoke.py's bwd phase: every case's K3 and K4 take the row its
    check expects (k1_row for bf16, the fp32 rows otherwise), and the
    cases reach each bf16 path K3 and K4 have up to D 256: TMA on the
    wgmma kernel, the copying producers on the wgmma and one-CTA
    head-dim-split kernels, and the mma.sync rows of block_d 128 and 256
    (2-byte shifts at D 100 and 250)."""
    import torch

    smoke = _chip_smoke()
    seen = set()
    for name, r, c, tag, opts, hq, hkv, d, shift in smoke.BWD_CASES:
        desc = AttentionDescriptor(
            batch=1, num_q_heads=hq, num_kv_heads=hkv, seq_len_q=64,
            seq_len_kv=64, head_dim=d, low_precision_inputs=tag == "bf16",
            low_precision_intermediates=tag == "bf16", **opts)
        dtype = torch.bfloat16 if tag == "bf16" else torch.float32
        buf = torch.zeros(64 * d + 8, dtype=dtype)
        at = shift // buf.element_size()
        q = buf[at:at + 64 * d].view(1, 64, d)
        kv = torch.zeros(1, 64, d, dtype=dtype)
        want = smoke.k1_row(d, shift) if tag == "bf16" else ""
        for kt in (AttentionKernelType.BACKWARD_QUERY,
                   AttentionKernelType.BACKWARD_KEY_VALUE):
            row = launch_row(desc.kernel_descriptor(kt), d, (q, kv, kv, q))
            assert row_label(row) == want, (name, kt)
            seen.add((row_label(row), row.block_d))
    assert {("wgmma", 128), ("wgmma/copy", 128), ("wgmma_dblk/copy", 256),
            ("mma", 128), ("mma", 256)} <= seen
