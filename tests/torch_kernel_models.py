"""Plain models of the port's CUDA kernels, for the tests to hold against
the JAX package on the CPU (``test_torch_kernels.py``,
``test_torch_selective_scan.py``) and against the kernels themselves on
the card (``test_torch_cuda_kernels.py``): in torch, the order in which
the FedAvg and Int8 reduces and the selective scan round; in numpy, how
the Int8 codec kernels split their work over a persistent grid.  Imports
torch and numpy only (the compositions the one-launch reduces replaced
import ``repro_torch`` where they are called)."""
import math

import numpy as np
import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf, elementwise: a * b + c rounded once to fp32.  In float64 the
    product is exact and the sum's rounding error is known exactly
    (TwoSum); that error decides a float64 sum that lands on the midpoint
    of two fp32 neighbours, where rounding it again would not."""
    a, b, c = (t.to(torch.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    r = s.to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, math.inf)).to(torch.float64)
    down = torch.nextafter(r, torch.full_like(r, -math.inf)).to(torch.float64)
    r64 = r.to(torch.float64)
    lo, hi = torch.where(r64 <= s, r64, down), torch.where(r64 <= s, up, r64)
    tie = (s == (lo + hi) / 2) & (e != 0)
    return torch.where(tie, torch.where(e > 0, hi, lo), r64).to(torch.float32)


def fedavg_one_launch(u: torch.Tensor, w: torch.Tensor, *, normalize: bool = True):
    """``csrc/fedavg_reduce.cu``'s arithmetic: the fp32 weight sum in client
    order (0 -> 1), wn = w / ws, one fmaf chain over the clients from 0,
    rounded to u's dtype; with ``normalize=False`` that mean times ws
    rounded to u's dtype, rounded again."""
    wf = w.to(torch.float32)
    ws = torch.zeros((), dtype=torch.float32, device=w.device)
    for c in range(wf.shape[0]):
        ws = ws + wf[c]
    ws = torch.where(ws == 0, torch.ones_like(ws), ws)
    wn = wf / ws
    acc = torch.zeros(u.shape[1], dtype=torch.float32, device=u.device)
    for c in range(u.shape[0]):
        acc = fma32(wn[c], u[c].to(torch.float32), acc)
    mean = acc.to(u.dtype)
    return mean if normalize else (mean.float() * ws.to(u.dtype).float()).to(u.dtype)


def _dequant_chain(q: torch.Tensor, s: torch.Tensor, wn: torch.Tensor) -> torch.Tensor:
    """The Int8 reduce's chain over the clients, from 0 in client order:
    acc = fmaf(wn_c, fl(code * scale), acc), each dequantized value
    rounded to fp32 on its own first."""
    c, n = q.shape
    x = (q.to(torch.float32).reshape(c, n // 256, 256) * s.to(torch.float32)[:, :, None])
    x = x.reshape(c, n)
    acc = torch.zeros(n, dtype=torch.float32, device=q.device)
    for k in range(c):
        acc = fma32(wn[k], x[k], acc)
    return acc


def dequant_reduce_one_launch(q: torch.Tensor, s: torch.Tensor, w: torch.Tensor, *,
                              normalize: bool = True) -> torch.Tensor:
    """``csrc/dequant_reduce.cu``'s arithmetic: the fp32 weight sum in
    client order (0 -> 1), wn = w / ws (IEEE division), the fmaf chain of
    fl(code * scale) over the clients from 0; with ``normalize=False``
    fl(mean * ws)."""
    wf = w.to(torch.float32)
    ws = torch.zeros((), dtype=torch.float32, device=w.device)
    for k in range(wf.shape[0]):
        ws = ws + wf[k]
    ws = torch.where(ws == 0, torch.ones_like(ws), ws)
    mean = _dequant_chain(q, s, wf / ws)
    return mean if normalize else mean * ws


def dequant_reduce_composition(q: torch.Tensor, s: torch.Tensor, w: torch.Tensor, *,
                               normalize: bool = True) -> torch.Tensor:
    """What ``ops.dequant_reduce`` ran on the card before its weight sum
    moved inside the launch: the weights normalized by PyTorch's
    ``safe_weight_sum`` (its own summation order), the kernel's fmaf chain,
    and for ``normalize=False`` that mean then ``ops._denormalize``."""
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import safe_weight_sum

    wf = w.to(torch.float32)
    mean = _dequant_chain(q, s, wf / safe_weight_sum(wf))
    return mean if normalize else ops._denormalize(mean, w)


def fedbuff_weights(counts, alpha: float = 0.5) -> torch.Tensor:
    """``FedBuffStrategy._fit_weights`` for client c with example count
    ``counts[c]`` and staleness c % 5 (0-4, what its default policy
    admits): the Python float ``n * (1 / (1 + s) ** alpha)``, then fp32.
    The first weights on ``Server.run``'s path that are not integers."""
    return torch.tensor(
        [float(n) * (1.0 / (1.0 + float(c % 5)) ** alpha) for c, n in enumerate(counts)],
        dtype=torch.float32,
    )


def reduce_error_units(out: torch.Tensor, plain: torch.Tensor, x: torch.Tensor,
                       w: torch.Tensor, *, normalize: bool = True) -> float:
    """max |out - plain| of two weighted reduces of the rows x (C, N), in
    units of 2**-24 * sum_c |w_c x_c| (divided by sum_c w_c for the mean):
    the first-order rounding budget of a weighted sum, in which every
    rounding of a product, a sum, the weight sum or a division costs at
    most one unit.  A mean that two reduces each form with C - 1 weight
    additions, C products-and-adds and one division (or division of the
    weights) differs by at most 4C units; the weighted sum (the weight
    sums cancel) by at most 2C + 4 <= 4C."""
    wf = w.to(torch.float64)
    budget = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    for c in range(x.shape[0]):
        budget += wf[c] * x[c].to(torch.float64).abs()
    if normalize:
        budget /= wf.sum()
    diff = (out.to(torch.float64) - plain.to(torch.float64)).abs()
    units = torch.where(budget > 0, diff / (budget * 2.0 ** -24),
                        torch.where(diff > 0, math.inf, 0.0))
    return float(units.max())


def scan_kernel_order(x, dt, A, Bm, Cm, D, *, init_state=None):
    """``csrc/selective_scan.cu``'s order: the state as the plain version
    rounds it (each product and sum on its own), the states padded with
    zeros to the kernel's bucket N_MAX (8, 16, 32 or 64), and y's sum over
    them as four partial sums -- state j into partial j % 4, in order of j
    -- added as (p0 + p1) + (p2 + p3), then D x added."""
    bsz, s, di = x.shape
    n = A.shape[-1]
    n_max = next(m for m in (8, 16, 32, 64) if n <= m)
    f32 = torch.float32

    def pad(t):
        return torch.nn.functional.pad(t.to(f32), (0, n_max - n))

    a, bm, cm, d = pad(A), pad(Bm), pad(Cm), D.to(f32)
    h = (pad(init_state) if init_state is not None
         else torch.zeros((bsz, di, n_max), dtype=f32, device=x.device))
    y = torch.empty_like(x)
    for t in range(s):
        x_t, dt_t = x[:, t].to(f32), dt[:, t].to(f32)
        h = torch.exp(dt_t[..., None] * a) * h + (dt_t * x_t)[..., None] * bm[:, t, None, :]
        prod = h * cm[:, t, None, :]
        part = [prod[..., r] for r in range(4)]
        for q in range(1, n_max // 4):
            part = [part[r] + prod[..., 4 * q + r] for r in range(4)]
        y[:, t] = (((part[0] + part[1]) + (part[2] + part[3])) + d * x_t).to(x.dtype)
    return y, h[..., :n].contiguous()


# ---------------- csrc/selective_scan.cu: the backward ----------------
SCAN_SEG = 8         # kSeg: steps between the forward's checkpoints
SCAN_THREADS = 512   # kBwdThreads: a backward block's threads, 16 warps
SCAN_PER = 4         # kPer: the states a backward thread keeps
SCAN_RANGE = 16      # kRange: the channels a thread of the dB / dC sums adds


def _scan_channel_sums(v: torch.Tensor, chan: int) -> torch.Tensor:
    """dB's or dC's sums of a step over each block's channels: v (..., Dp,
    Nm), Dp whole blocks of ``chan`` channels -> (..., blocks, Nm): each
    range of SCAN_RANGE channels added in channel order, then the ranges
    in range order."""
    r = v.reshape(*v.shape[:-2], v.shape[-2] // chan, chan // SCAN_RANGE, SCAN_RANGE,
                  v.shape[-1])
    acc = r[..., 0, :]
    for c in range(1, SCAN_RANGE):
        acc = acc + r[..., c, :]
    out = acc[..., 0, :]
    for q in range(1, acc.shape[-2]):
        out = out + acc[..., q, :]
    return out


def scan_bwd_kernel_order(x, dt, A, Bm, Cm, D, dy, *, init_state=None, dh_final=None,
                          groups: int = 1):
    """``csrc/selective_scan.cu``'s backward, step for step, on any device
    (on the card torch's exp is the kernel's expf): the forward's
    checkpoints (the state entering every SCAN_SEG-th step, in the plain
    roundings), then the segments from last to first, each recomputing
    its states from its checkpoint -- keeping each step's a_t and rounded
    a_t h_{t-1}, so one exp a state-step -- and walking them back.
    Channels are padded to whole blocks and states to the bucket N_MAX, as
    the kernel's dead lanes are; a thread keeps SCAN_PER = 4 states, so
    N_MAX / 4 threads a channel and 512 / (N_MAX / 4) channels a block.
    The roundings are the kernel's: fmaf where it calls fmaf (``fma32``),
    each thread's sums over its states in order, the threads of a channel
    added in order, dB and dC by ``_scan_channel_sums`` then the blocks in
    order, dA and dD over each group's rows in order.  Returns ((dx, ddt, dA, dB, dC, dD, dh0 or
    None) as ``ref.selective_scan_bwd`` returns them, the checkpoints in
    the kernel's layout (B, ceil(S / 8), N, Di), whether every recomputed
    state equals the forward's bitwise)."""
    f32 = torch.float32
    bsz, s, di = x.shape
    n = A.shape[-1]
    n_max = next(m for m in (8, 16, 32, 64) if n <= m)
    per = SCAN_PER
    sub = n_max // per
    chan = SCAN_THREADS // sub
    blocks = -(-di // chan)
    dpad = blocks * chan
    segs = -(-s // SCAN_SEG)
    rows = bsz // groups

    def pad(t, *widths):  # zeros past Di and N: the kernel's dead channels and states
        t = t.to(f32)
        return torch.nn.functional.pad(t, [p for w in reversed(widths) for p in (0, w)])

    a3 = (A if A.dim() == 3 else A[None]).to(f32).repeat_interleave(rows, 0)
    d2 = (D if D.dim() == 2 else D[None]).to(f32).repeat_interleave(rows, 0)
    a = pad(a3, dpad - di, n_max - n)                        # (B, Dp, Nm)
    dd = pad(d2, dpad - di)                                  # (B, Dp)
    xs, dts, dys = (pad(t, dpad - di) for t in (x, dt, dy))  # (B, S, Dp)
    bs, cs = (pad(t, n_max - n) for t in (Bm, Cm))           # (B, S, Nm)

    def step(h, t):  # -> (a_t, a_t h_{t-1}, h_t)
        decay = torch.exp(dts[:, t, :, None] * a)
        kept = decay * h
        return decay, kept, kept + (dts[:, t] * xs[:, t])[..., None] * bs[:, t, None, :]

    h = (pad(init_state, dpad - di, n_max - n) if init_state is not None
         else torch.zeros((bsz, dpad, n_max), dtype=f32, device=x.device))
    ckpt, forward = [], []
    for t in range(s):
        if t % SCAN_SEG == 0:
            ckpt.append(h)
        forward.append(h)
        h = step(h, t)[2]

    g = (pad(dh_final, dpad - di, n_max - n) if dh_final is not None
         else torch.zeros((bsz, dpad, n_max), dtype=f32, device=x.device))
    gda = torch.zeros_like(g)
    gdd = torch.zeros((bsz, dpad), dtype=f32, device=x.device)
    dx = torch.empty((bsz, s, dpad), dtype=f32, device=x.device)
    ddt = torch.empty_like(dx)
    part = torch.empty((2, bsz, blocks, s, n_max), dtype=f32, device=x.device)
    same = True
    for k in reversed(range(segs)):
        t0 = k * SCAN_SEG
        st, kept = ckpt[k], []
        for t in range(t0, min(t0 + SCAN_SEG, s)):
            same = same and torch.equal(st, forward[t])
            decay, dh, st = step(st, t)
            kept.append((decay, dh))
            part[1, :, :, t] = _scan_channel_sums(dys[:, t, :, None] * st, chan)
        for t in reversed(range(t0, min(t0 + SCAN_SEG, s))):
            xv, dtv, dyv = xs[:, t], dts[:, t], dys[:, t]
            ux = dtv * xv
            g = fma32(dyv[..., None], cs[:, t, None, :], g)              # g_t
            decay, dh = kept[t - t0]                                      # a_t, a_t h_{t-1}
            sens = dh * g
            du = torch.zeros((bsz, dpad, sub), dtype=f32, device=x.device)
            dsum = torch.zeros_like(du)
            gs, bq, sq, aq = (v.reshape(bsz, dpad, sub, per) for v in
                              (g, bs[:, t, None, :].expand_as(g), sens, a))
            for i in range(per):  # each thread's states in order
                du = fma32(gs[..., i], bq[..., i], du)
                dsum = fma32(aq[..., i], sq[..., i], dsum)
            terms = du, dsum
            du, dsum = terms[0][..., 0], terms[1][..., 0]
            for q in range(1, sub):  # the channel's threads in order
                du, dsum = du + terms[0][..., q], dsum + terms[1][..., q]
            dx[:, t] = fma32(dtv, du, dd * dyv)
            ddt[:, t] = fma32(xv, du, dsum)
            gda = fma32(dtv[..., None], sens, gda)
            gdd = fma32(dyv, xv, gdd)
            part[0, :, :, t] = _scan_channel_sums(ux[..., None] * g, chan)
            g = decay * g                                                 # a_t g_t
    sums = part[:, :, 0]
    for q in range(1, blocks):  # the blocks' partials in block order
        sums = sums + part[:, :, q]
    gda4 = gda.reshape(groups, rows, dpad, n_max)
    gdd3 = gdd.reshape(groups, rows, dpad)
    da, dd_ = gda4[:, 0], gdd3[:, 0]
    for r in range(1, rows):  # each group's rows in row order
        da, dd_ = da + gda4[:, r], dd_ + gdd3[:, r]
    da, dd_ = da[:, :di, :n], dd_[:, :di]
    if A.dim() == 2:
        da, dd_ = da[0], dd_[0]
    grads = (dx[..., :di].to(x.dtype), ddt[..., :di], da, sums[0][..., :n], sums[1][..., :n], dd_,
             g[:, :di, :n] if init_state is not None else None)
    return grads, torch.stack(ckpt, 1)[:, :, :di, :n].transpose(2, 3).contiguous(), same


# ---------------- csrc/quantize.cu: the persistent grids' work split ----------------
CODEC_BLOCK, CODEC_WARPS, CODEC_CODES = 256, 8, 16


def codec_grid(warp_steps: int, resident_ctas: int) -> int:
    """``grid_for``: one CTA a CODEC_WARPS warp-steps, at most the CTAs
    resident at once."""
    return min(-(-warp_steps // CODEC_WARPS), resident_ctas)


def quantize_launch(x: np.ndarray, resident_ctas: int, stages: int = 2):
    """``quantize_int8_kernel`` on fp32 ``x`` (n,), any n: warp w of the
    grid's ``stride`` warps takes blocks w, w + stride, ..., the copies of
    each block issued ``stages - 1`` strides ahead of its quantization
    (its ring of ``stages`` slots); a lane copies two 16-byte pieces of a
    block, the piece that straddles n only up to n, and values at or past n
    read as 0.  Returns (q, scales, block_visits, x_reads): q and scales as
    the kernel writes them (a code never written stays -128, a scale NaN),
    the times each block is quantized, and the times each index of x is
    read (those at or past n in the tail entries, up to the padded
    length)."""
    n = x.shape[0]
    n_blocks = -(-n // CODEC_BLOCK)
    stride = codec_grid(n_blocks, resident_ctas) * CODEC_WARPS
    q = np.full(n_blocks * CODEC_BLOCK, -128, np.int8)
    scales = np.full(n_blocks, np.nan, np.float32)
    visits = np.zeros(n_blocks, np.int64)
    reads = np.zeros(n_blocks * CODEC_BLOCK, np.int64)

    def copy(blk):
        vals = np.zeros(CODEC_BLOCK, np.float32)
        base = blk * CODEC_BLOCK
        for lane in range(32):
            for i in (base + 4 * lane, base + 128 + 4 * lane):
                idx = np.arange(i, min(i + 4, n))  # 16 bytes, or the bytes before n
                reads[idx] += 1
                vals[idx - base] = x[idx]
        return vals

    for warp in range(stride):
        mine = range(warp, n_blocks, stride)
        ring = [copy(b) for b in mine[:stages - 1]]  # the prologue's copies
        for k, blk in enumerate(mine):
            if k + stages - 1 < len(mine):
                ring.append(copy(mine[k + stages - 1]))
            cur = ring.pop(0)
            absmax = np.float32(np.abs(cur).max())  # NaN-free inputs here
            scale = absmax / np.float32(127.0)
            scale = np.float32(1.0) if scale == 0 else scale
            codes = np.clip(np.rint(cur / scale), -127, 127)
            q[blk * CODEC_BLOCK:(blk + 1) * CODEC_BLOCK] = codes.astype(np.int8)
            scales[blk] = scale
            visits[blk] += 1
    return q, scales, visits, reads


def dequantize_launch(q: np.ndarray, scales: np.ndarray, resident_ctas: int):
    """``dequantize_int8_kernel``: a warp-step is two blocks (the last step
    of an odd block count one); warp w takes steps w, w + stride, ...; lane
    l reads the 4-code words 32 j + l of the step (j = 0..3; j = 2, 3 only
    if the second block exists) and writes their 4 values, lanes 0 and 1
    read the two blocks' scales.  Returns (x, code_reads, scale_reads,
    writes)."""
    n_blocks = scales.shape[0]
    steps = -(-n_blocks // 2)
    stride = codec_grid(steps, resident_ctas) * CODEC_WARPS
    x = np.full(q.shape[0], np.nan, np.float32)
    code_reads = np.zeros(q.shape[0], np.int64)
    scale_reads = np.zeros(n_blocks, np.int64)
    writes = np.zeros(q.shape[0], np.int64)
    for warp in range(stride):
        for step in range(warp, steps, stride):
            second = 2 * step + 1 < n_blocks
            s = [scales[2 * step + lane] for lane in (0, 1) if lane == 0 or second]
            scale_reads[2 * step:2 * step + len(s)] += 1
            for lane in range(32):
                for j in range(4) if second else range(2):
                    word = step * 128 + 32 * j + lane
                    span = slice(4 * word, 4 * word + 4)
                    code_reads[span] += 1
                    x[span] = q[span].astype(np.float32) * s[j // 2]
                    writes[span] += 1
    return x, code_reads, scale_reads, writes


# ---------------- csrc/collective_quant.cu: the leaf table ----------------
def collective_leaf_walk(sizes, resident_ctas: int):
    """``collective_absmax_kernel`` and ``collective_pack_kernel``'s work
    split over a table of leaves of ``sizes`` values: leaf i owns blocks
    [first_i, first_i + ceil(n_i / 256)) of the flat layout; warp w of the
    grid's ``stride`` warps takes blocks w, w + stride, ... and finds each
    one's leaf by walking the table forward from the last it found; lane l
    reads values [4l, 4l + 4) and [128 + 4l, ...) of the leaf's block, only
    those before the leaf's n.  Returns (the leaf found for each block,
    visits per block, reads per value of each leaf)."""
    first = [0]
    for n in sizes:
        first.append(first[-1] + -(-n // CODEC_BLOCK))
    n_blocks = first[-1]
    stride = codec_grid(n_blocks, resident_ctas) * CODEC_WARPS
    found = np.full(n_blocks, -1, np.int64)
    visits = np.zeros(n_blocks, np.int64)
    reads = [np.zeros(n, np.int64) for n in sizes]
    for warp in range(stride):
        leaf = 0
        for blk in range(warp, n_blocks, stride):
            while first[leaf + 1] <= blk:
                leaf += 1
            found[blk] = leaf
            visits[blk] += 1
            base = (blk - first[leaf]) * CODEC_BLOCK
            for lane in range(32):
                for i in (base + 4 * lane, base + 128 + 4 * lane):
                    reads[leaf][i:min(i + 4, sizes[leaf])] += 1
    return found, visits, reads


def collective_per_leaf(ds, wf, rs, live, pack, unpack, block: int = 256):
    """The per-leaf composition that the leaf-table collective kernels
    replaced: the mesh round step zeroing a masked rank's leaves, then
    ``CompressedPsum.psum`` once a leaf with no tier to reduce over:
    wx = d * wf, eff = wx + (r, or 0 for a masked rank), padded, the block
    absmax (``torch.amax``: NaN kept), scale = absmax / 127 (0 -> 1),
    ``pack``, ``unpack`` of the codes twice (what the rank sent, and the
    total after the hops), eff - sent, and a masked rank's residual
    carried.  Returns per leaf (absmax, scales, codes, total, new
    residual)."""
    out = []
    for d, r in zip(ds, rs, strict=True):
        n = d.shape[0]
        if live is not None:
            d = torch.where(live, d, torch.zeros_like(d))
        wx = d * wf
        r_in = r if live is None else torch.where(live, r, torch.zeros_like(r))
        eff = wx + r_in
        pad = (-n) % block
        effp = torch.nn.functional.pad(eff, (0, pad)) if pad else eff
        absmax = effp.abs().reshape(-1, block).amax(dim=1)
        s = torch.where(absmax == 0.0, torch.ones_like(absmax),
                        absmax / torch.full_like(absmax, 127.0))
        q = pack(effp, s)
        sent = unpack(q, s)[:n]
        total = unpack(q, s)[:n]
        new = eff - sent
        if live is not None:
            new = torch.where(live, new, r)
        out.append((absmax, s, q, total, new))
    return out


# ---------------- the flash backward's bf16 route (csrc/flash_attention.cu) ----------------
# label, B, Sq, Skv, H, KV, D, dtype, window, q_offset, causal: the training
# shapes of chip_smoke.py phase 17 (a) (qwen3-0.6b's layer at 4 clients x 2
# sequences of 512 folded into B = 8) and the other heads and masks the
# backward takes, new cases last (the card test's ids number them in order)
FLASH_BWD_CASES = [
    ("training shape", 8, 512, 512, 16, 8, 128, torch.bfloat16, None, 0, True),
    ("fp32, training shape", 8, 512, 512, 16, 8, 128, torch.float32, None, 0, True),
    ("GQA 32/8", 2, 512, 512, 32, 8, 128, torch.bfloat16, None, 0, True),
    ("stablelm-3b's D = 80", 2, 256, 256, 32, 32, 80, torch.bfloat16, None, 0, True),
    ("fp32 D = 64", 2, 256, 256, 8, 2, 64, torch.float32, None, 0, True),
    ("window 100 at q_offset 256", 2, 128, 384, 8, 4, 64, torch.bfloat16, 100, 256, True),
    ("ragged S = 300", 2, 300, 300, 16, 8, 128, torch.bfloat16, None, 0, True),
    ("fp32 not causal, D = 256", 1, 65, 130, 4, 4, 256, torch.float32, None, 0, False),
    ("fp32 rows with no valid key", 1, 8, 24, 2, 1, 40, torch.float32, 3, 20, True),
    ("paligemma-3b's 8 over 1 at D = 256", 2, 512, 512, 8, 1, 256, torch.bfloat16, None, 0, True),
    ("MLA's qk 96", 2, 512, 512, 16, 16, 96, torch.bfloat16, None, 0, True),
    ("musicgen-medium's 24 x 64", 2, 512, 512, 24, 24, 64, torch.bfloat16, None, 0, True),
    ("bf16 rows with no valid key", 1, 8, 24, 2, 1, 40, torch.bfloat16, 3, 20, True),
    # rows from 115 on have no valid key; D = 256: two passes, 32-row tiles
    ("bf16 rows with no valid key, window 16, D = 256", 2, 200, 300, 4, 2, 256, torch.bfloat16,
     16, 200, True),
]


def _d_pad(d: int) -> int:
    return 64 if d <= 64 else 128 if d <= 128 else 256


class Heaviest:
    """The kernels' ``Heaviest``: tiles by weight, heaviest first, as the
    merge of the two sides of the first heaviest tile (the left one on a
    tie); ``seek(r)`` moves on to rank r, ranks only growing."""

    def __init__(self, weights):
        self.w = list(weights)
        self.at = max(range(len(self.w)), key=lambda t: (self.w[t], -t))
        self.left, self.right, self.rank = self.at - 1, self.at + 1, 0

    def seek(self, r: int) -> int:
        for self.rank in range(self.rank, r):
            if self.left >= 0 and (self.right >= len(self.w)
                                   or self.w[self.left] >= self.w[self.right]):
                self.at, self.left = self.left, self.left - 1
            else:
                self.at, self.right = self.right, self.right + 1
        self.rank = max(self.rank, r)
        return self.at


def _key_span(bk, sq, skv, q0, rows, window, q_offset, causal):
    """The key tiles (kt0, n) the rows [q0, q0 + rows) reach (``key_span``)."""
    qlo, qhi = q0 + q_offset, min(q0 + rows, sq) - 1 + q_offset
    lo = max(qlo - window + 1, 0) if window is not None else 0
    hi = min(qhi, skv - 1) if causal else skv - 1
    return lo // bk, (hi // bk + 1 - lo // bk if hi >= lo else 0)


def _query_span(bq, sq, skv, k0, window, q_offset, causal):
    """(f, n1, qe, m): the query tiles keys [k0, k0 + 128) reach, [f, f + n1)
    then [qe, n_qt) (``query_span``)."""
    n_qt = -(-sq // bq)
    k1 = min(k0 + 128, skv) - 1
    r_lo = max(k0 - q_offset if causal else 0, 0)
    r_hi = min(k1 + window - 1 - q_offset if window is not None else sq - 1, sq - 1)
    r_e = sq
    if window is not None:
        r_e = 0 if causal and window == 0 else max(skv + window - 1 - q_offset, 0)
    qe = n_qt if r_e >= sq else r_e // bq
    a0, a1 = (r_lo // bq, r_hi // bq + 1) if r_lo <= r_hi else (0, 0)
    f = min(a0, qe)
    n1 = max(0, min(a1, qe) - f)
    return f, n1, qe, n1 + n_qt - qe


def flash_bwd_dq_walk(b, sq, skv, h, kv, d, window, q_offset, causal, n_sms=132):
    """The dQ kernel's work: per persistent CTA its items in order, each
    (b, h, query tile of 128 rows, [the key tiles it walks], its weight)."""
    bk = 32 if _d_pad(d) == 256 else 64
    n_qt = -(-sq // 128)
    spans = [_key_span(bk, sq, skv, qt * 128, 128, window, q_offset, causal)
             for qt in range(n_qt)]
    n_items = n_qt * b * h
    ctas = []
    for c in range(min(n_items, n_sms)):
        order, items = Heaviest(n for _, n in spans), []
        for w in range(c, n_items, min(n_items, n_sms)):
            qt = order.seek(w // (b * h))
            kt0, n = spans[qt]
            items.append((w % (b * h) // h, w % (b * h) % h, qt, list(range(kt0, kt0 + n)), n))
        ctas.append(items)
    return ctas


def flash_bwd_dkv_walk(b, sq, skv, h, kv, d, window, q_offset, causal, n_sms=132):
    """The dK / dV kernel's work: per persistent CTA its items in order, each
    (b, KV head, key tile of 128, [(pass, query head, query tile)] in the
    order it walks them, its weight), query tiles of 64 rows (32 and four
    passes at D_pad = 256: dV's column halves, then dK's)."""
    bq, passes = (32, 4) if _d_pad(d) == 256 else (64, 1)
    g = h // kv
    n_kt = -(-skv // 128)
    spans = [_query_span(bq, sq, skv, kt * 128, window, q_offset, causal) for kt in range(n_kt)]
    n_items = n_kt * b * kv
    ctas = []
    for c in range(min(n_items, n_sms)):
        order, items = Heaviest(s[3] for s in spans), []
        for w in range(c, n_items, min(n_items, n_sms)):
            kt = order.seek(w // (b * kv))
            f, n1, qe, m = spans[kt]
            kvh = w % (b * kv) % kv
            tiles = []
            for i in range(passes * g * m):
                rem = i % (g * m)
                qi = rem % m
                tiles.append((i // (g * m), kvh * g + rem // m, f + qi if qi < n1 else qe + qi - n1))
            items.append((w % (b * kv) // kv, kvh, kt, tiles, m))
        ctas.append(items)
    return ctas


def flash_bwd_bf16_model(q, k, v, out, lse, dout, *, causal=True, window=None, q_offset=0):
    """The bf16 route's arithmetic in plain torch: bf16 operands, fp32 sums;
    delta = rowsum(dO * O) in fp32; P = exp(S scale - lse) (1 / Skv across a
    row with no valid key) and dS = P (dP - delta) where the pair attends,
    each rounded to bf16 before its product (P^T . dO, dS^T . Q, dS . K), as
    the kernels round P^T and dS^T (and the dQ kernel dS) in registers; the
    scale on dQ and dK at the end.  -> (dq, dk, dv) in q's dtype."""
    from repro_torch.kernels.ref import attention_mask

    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g, scale, f32, bf16 = h // kv, d ** -0.5, torch.float32, torch.bfloat16
    qf = q.to(f32).transpose(1, 2)
    kf = torch.repeat_interleave(k.to(f32), g, dim=2).transpose(1, 2)
    vf = torch.repeat_interleave(v.to(f32), g, dim=2).transpose(1, 2)
    do = dout.to(f32).transpose(1, 2)
    mask = attention_mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    delta = (do * out.to(f32).transpose(1, 2)).sum(-1, keepdim=True)
    p = torch.where(mask, torch.exp(qf @ kf.transpose(-1, -2) * scale - lse[..., None]), 0.0)
    p = torch.where(mask.any(-1, keepdim=True), p, 1.0 / skv)
    ds = torch.where(mask, p * (do @ vf.transpose(-1, -2) - delta), 0.0)
    pb, dsb = p.to(bf16).to(f32), ds.to(bf16).to(f32)
    dq = dsb @ kf * scale
    dk = (dsb.transpose(-1, -2) @ qf).reshape(b, kv, g, skv, d).sum(2) * scale
    dv = (pb.transpose(-1, -2) @ do).reshape(b, kv, g, skv, d).sum(2)
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))
