"""Test utilities: seeded problem generation, canaries and tolerance
checks.

Port of ``mfa_tpu/utils/testing.py``. Inputs come from a numpy
``Generator`` so that the same arrays can be fed to ``mfa_tpu`` and to
this package. :func:`nan_canary` prefills an output buffer so that an
element a kernel never writes shows; :func:`garbage_pad` surrounds an
operand with garbage so that a read past its bounds shows.
"""

from __future__ import annotations

import numpy as np
import torch


def make_attention_inputs(rng: np.random.Generator, batch: int,
                          num_q_heads: int, num_kv_heads: int,
                          seq_len_q: int, seq_len_kv: int, head_dim: int,
                          dtype: torch.dtype = torch.float32,
                          device="cpu"):
    """Standard-normal Q/K/V/dO as [B, H, S, D] tensors."""
    def gen(h, s):
        x = rng.standard_normal((batch, h, s, head_dim)).astype(np.float32)
        return torch.from_numpy(x).to(device=device, dtype=dtype)

    q = gen(num_q_heads, seq_len_q)
    k = gen(num_kv_heads, seq_len_kv)
    v = gen(num_kv_heads, seq_len_kv)
    do = gen(num_q_heads, seq_len_q)
    return q, k, v, do


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def nan_canary(shape, dtype: torch.dtype = torch.float32, device="cpu"):
    """An output buffer prefilled with NaN: catches a kernel that never
    writes some of its elements."""
    return torch.full(shape, float("nan"), dtype=dtype, device=device)


def shifted_copy(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts ``nbytes`` (a multiple
    of its element size, below 16) past a 16-byte boundary: a cache view
    whose base shares only that alignment."""
    es = x.element_size()
    if nbytes % es or not 0 <= nbytes < 16:
        raise ValueError(f"cannot shift {x.dtype} data by {nbytes} bytes")
    buf = torch.empty(x.numel() + 32 // es, dtype=x.dtype, device=x.device)
    at = (-buf.data_ptr() % 16 + nbytes) // es
    return buf[at:at + x.numel()].view(x.shape).copy_(x)


def garbage_pad(x: torch.Tensor, s_pad: int, d_pad: int,
                rng: np.random.Generator) -> torch.Tensor:
    """Pad the sequence/head tail of a [N, S, D] operand to [N, s_pad,
    d_pad] with uniform garbage in [-20, 20] instead of zeros, so a kernel
    that reads past the declared bounds corrupts its outputs detectably.
    Returns ``x`` itself when no padding is asked for."""
    n, s, d = x.shape
    if s == s_pad and d == d_pad:
        return x
    out = torch.from_numpy(rng.uniform(-20.0, 20.0, size=(n, s_pad, d_pad)))
    out = out.to(device=x.device, dtype=x.dtype)
    out[:, :s, :d] = x
    return out


def shuffled_page_pool(storage: torch.dtype, lengths, num_kv_heads: int,
                       head_dim: int, page_size: int, max_pages: int, *,
                       generator: torch.Generator, device="cpu"):
    """A page pool holding random rows for sequences of ``lengths``, their
    live pages at shuffled ids among twice as many. Page 0 (the null page)
    and the unused pages hold NaN (int8: -128) with NaN scales, so a
    kernel that reads one shows it. Returns (k_pages, v_pages, k_scale,
    v_scale, tables) with pages [P, Hkv, page, D] in ``storage``, scales
    [P, Hkv, page] fp32 and tables [S, max_pages] int32 (0 past the live
    pages)."""
    from mfa_tpu_torch.kernels import quant

    need = [-(-int(x) // page_size) for x in lengths]
    num_pages = 2 * sum(need) + 2
    x = torch.randn((2, num_pages, num_kv_heads, page_size, head_dim),
                    generator=generator, device=device)
    pages, scales = zip(*(quant.quantize_for(storage, x[i]) for i in (0, 1)))
    ids = (torch.randperm(num_pages - 1, generator=generator, device=device)
           + 1).tolist()[:sum(need)]
    dead = sorted(set(range(num_pages)) - set(ids))
    poison = (torch.full((), -128, dtype=torch.int8, device=device)
              if storage == torch.int8
              else torch.full((), float("nan"), device=device).to(storage))
    for t in pages:
        t[dead] = poison
    for t in scales:
        t[dead] = float("nan")
    tables = torch.zeros((len(need), max_pages), dtype=torch.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = torch.tensor(ids[at:at + n])
        at += n
    return (*pages, *scales, tables.to(device))


# A kernel against its plain version on the card: same inputs and the same
# rounding points, so they differ only by summation order and, for flash
# forward in bf16, by P rounded against the running instead of the final
# row max. In the bf16 backward, S and dP come from tensor-core sums,
# dS = P (dP - D) cancels (which magnifies their relative difference),
# and the bf16 rounding of P or dS may then fall the other way; dQ and dK
# sum up to group * 2048 such terms, each far larger than the result.
# On an H100 (causal, N = 2048, D = 128) that left |d| up to 1.5e-3 in
# dQ and dK, against ~2e-4 between two fp32 summation orders on the CPU.
# Elementwise budgets (atol, rtol): |kernel - plain| <= atol + rtol *
# |plain|. 2^-6 is two bf16 ulps of the value itself.
KERNEL_BUDGETS = {
    "flash_fwd_o_bf16": (3e-3, 2.0 ** -6),
    "flash_fwd_o_fp32": (2e-5, 0.0),
    "flash_fwd_l": (1e-4, 0.0),
    "decode_o": (1e-4, 2.0 ** -6),
    # K5 and K6 take the final row max before they form P, so they round
    # S, P * vs and O at the plain version's points, as K2 does: K2's
    # budget, for the summation order and exp2's last bits alone.
    "decode_attend_o": (1e-4, 2.0 ** -6),
    "paged_decode_o": (1e-4, 2.0 ** -6),
    "flash_bwd_dq_bf16": (5e-3, 2.0 ** -6),
    "flash_bwd_dk_bf16": (5e-3, 2.0 ** -6),
    "flash_bwd_dv_bf16": (5e-3, 2.0 ** -6),
    "flash_bwd_dq_fp32": (2e-5, 1e-5),
    "flash_bwd_dk_fp32": (2e-5, 1e-5),
    "flash_bwd_dv_fp32": (2e-5, 1e-5),
    "flash_bwd_dterm": (1e-5, 1e-5),
    # K7 against its plain version (the fp32 product of the upcast
    # operands): the products are exact in both, the fp32 sums are taken
    # in another order (|d| ~ sqrt(K) * 2^-24 * |C|, below 1e-3 for
    # unit-normal operands at K = 4096), and a 16-bit C may then round the
    # other way: one ulp, at most 2^-7 * |C|; 2^-6 leaves room for two.
    "gemm_bf16": (1e-3, 2.0 ** -6),
    # fp32 operands and C: summation order alone. Each side rounds K
    # partial sums of size ~sqrt(K), so |d| ~ K * 2^-24 in rms (~1e-4 at
    # K = 1536 for unit-normal operands) and ~5x that at the tail of a
    # few million elements: 4.4e-4 against cuBLAS's fp32 product on an
    # H100 at 1536^3. Callers scale atol by max(1, K / 4096).
    "gemm_fp32": (2e-3, 1e-5),
    # K8 against its plain version: bf16 x times a widened nibble is exact
    # in fp32 on both sides; the sums differ in order only, then the bf16
    # cast of y may round the other way (one ulp). The biased layout sums
    # x * (q + 8) and subtracts 8 * rowsum(x), both ~8x larger than the
    # result, so its summation differences count twice as much.
    "int4_matmul_signed": (1e-3, 2.0 ** -6),
    "int4_matmul_biased": (2e-3, 2.0 ** -6),
}


def budget_share(actual: torch.Tensor, expected: torch.Tensor, atol: float,
                 rtol: float, scale: torch.Tensor | None = None) -> float:
    """Worst |actual - expected| / (atol + rtol * |scale|) over the
    elements, ``scale`` defaulting to ``expected``: the share of an
    elementwise budget used (<= 1 is within). For a weighted sum whose
    terms cancel (attention's O = sum P v / l near 0 from large terms),
    pass the sum of the terms' magnitudes (sum P |v| / l) as ``scale``:
    a rounding step of one term then counts against the terms, not
    against their small sum."""
    e = expected.float()
    mag = e.abs() if scale is None else scale.float().abs()
    return float(((actual.float() - e).abs() / (atol + rtol * mag)).max())


def decode_fp64(q3, k, v, k_scale, v_scale, k_new, v_new, lengths, *,
                num_kv_heads: int, sliding_window: int | None = None,
                magnitudes: bool = False) -> torch.Tensor:
    """K2's one-token decode in fp64 over the live rows (dequantized where
    the cache is int8 or FP8) and the new token, nothing rounded; with
    ``magnitudes``, over |v|: sum P |v| / l, the size of O's terms. Takes
    K2's operands as the kernel does (q3 [B*Hkv, G, D] in log2 units);
    reads the cache and writes nothing."""
    quantized = k.dtype in (torch.int8, torch.float8_e4m3fn,
                            torch.float8_e5m2)
    kf, vf = k.double(), v.double()
    if quantized:
        kf = kf * k_scale.double()[..., None]
        vf = vf * v_scale.double()[..., None]
    vn = v_new.double()
    if magnitudes:
        vf, vn = vf.abs(), vn.abs()
    lens = lengths.long().clamp(0, k.shape[1]).repeat_interleave(
        num_kv_heads)[:, None]
    col = torch.arange(k.shape[1], device=k.device)[None, :]
    live = col < lens
    if sliding_window is not None:
        live &= col >= (lens + 1 - sliding_window).clamp_min(0)
    s = torch.einsum("bgd,bld->bgl", q3.double(), kf)
    s = torch.where(live[:, None, :], s, -1e300)
    s_new = torch.einsum("bgd,bd->bg", q3.double(), k_new.double())[..., None]
    m = torch.maximum(s.amax(-1, keepdim=True), s_new)
    p, p_new = torch.exp2(s - m), torch.exp2(s_new - m)
    return ((torch.einsum("bgl,bld->bgd", p, vf) + p_new * vn[:, None, :])
            / (p.sum(-1, keepdim=True) + p_new))


def attention_fp64(q3, k3, v3, *, group: int, scale: float,
                   causal: bool = False, sliding_window: int | None = None,
                   logit_soft_cap: float | None = None,
                   magnitudes: bool = False, heads: int = 4) -> torch.Tensor:
    """K1's attention in fp64, nothing rounded: q3 [BH, R, D] against k3,
    v3 [BH / group, C, D] (K1's operands and masks, natural-log scale);
    rows with no visible key give 0. With ``magnitudes``, over |v|: sum P
    |v| / l, the size of O's terms. ``heads`` query heads at a time (an
    [R, C] fp64 score matrix each)."""
    from mfa_tpu_torch.kernels.flash_fwd import visible_mask

    r, c = q3.shape[1], k3.shape[1]
    vis = visible_mask(r, c, causal, sliding_window, q3.device)
    out = torch.empty(q3.shape, dtype=torch.float64, device=q3.device)
    for h0 in range(0, q3.shape[0], heads):
        idx = torch.arange(h0, min(h0 + heads, q3.shape[0]),
                           device=q3.device)
        kf, vf = k3[idx // group].double(), v3[idx // group].double()
        s = torch.bmm(q3[idx].double(), kf.transpose(1, 2)) * scale
        if logit_soft_cap is not None:
            s = logit_soft_cap * torch.tanh(s / logit_soft_cap)
        p = torch.softmax(s.masked_fill(~vis, -torch.inf), dim=-1)
        out[idx] = torch.bmm(p.nan_to_num(0.0),
                             vf.abs() if magnitudes else vf)
    return out


def rounding_steps(o: torch.Tensor, exact: torch.Tensor, terms: torch.Tensor,
                   atol: float) -> torch.Tensor:
    """|o - exact| elementwise in bf16 steps (2^-7) of ``terms``, plus
    ``atol``: how far an attention's O lies from its fp64 value
    (decode_fp64, attention_fp64), counted in roundings of its largest
    terms."""
    return ((o.double() - exact).abs()
            / (atol + 2.0 ** -7 * terms.abs())).float()


def assert_close(actual, expected, tol: float, name: str = "operand",
                 max_report: int = 10, rtol: float = 0.0):
    """Elementwise |actual - expected| <= tol + rtol * |expected| with a
    capped report; positions where both sides are non-finite agree."""
    a, e = _np32(actual), _np32(expected)
    assert a.shape == e.shape, f"{name}: shape {a.shape} != {e.shape}"
    both_nonfinite = ~np.isfinite(a) & ~np.isfinite(e)
    diff = np.abs(a - e)
    diff[both_nonfinite] = 0.0
    bad = ~(diff <= tol + rtol * np.abs(np.nan_to_num(e)))
    if bad.any():
        idx = np.argwhere(bad)[:max_report]
        lines = [
            f"  [{tuple(int(j) for j in i)}] got {a[tuple(i)]:.6g} "
            f"want {e[tuple(i)]:.6g} (|d|={diff[tuple(i)]:.3g})"
            for i in idx
        ]
        raise AssertionError(
            f"{name}: {int(bad.sum())}/{a.size} elements exceed tol={tol:g} "
            f"rtol={rtol:g} "
            f"(max |d|={np.nanmax(diff):.3g}):\n" + "\n".join(lines))


def assert_fully_written(out, name: str = "output"):
    """Every element of a kernel output must be finite."""
    a = _np32(out)
    bad = ~np.isfinite(a)
    if bad.any():
        idx = tuple(int(j) for j in np.argwhere(bad)[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())}/{a.size} elements never written or "
            f"non-finite (first at {idx})")
