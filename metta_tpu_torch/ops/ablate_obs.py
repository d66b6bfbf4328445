"""Section ablations of the batched renders K1 and K4: wrappers and plain versions.

Counterpart of the TPU kernels' variants in ``scripts/ablate_obs3.py``
(K1, ``make_kernel`` :40) and ``scripts/ablate_obs.py`` (K4, ``make_kernel``
:36). Both CUDA kernels are templates on a mask of their sections; a set
bit replaces the section by a stub that reads no device memory, and mask 0
is the render itself. S5 ablates the production K1, ``csrc/obs_render3.cu``
(``obs_render3_ablate_launch``), and S4 the production K4,
``csrc/obs_render2.cu`` (``obs_render2_ablate_launch``, at one pass of 128
window cells), each on the render's own grid.

- K1's sections (:data:`SECTIONS3`, the persistent kernel's steps):
  ``globals`` (the global-token loads and their staging writes),
  ``winread`` (step 1's grid loads), ``count`` (step 1's count loads),
  ``scan`` (step 2's warp scan and carry), ``copy`` (step 3: the lane
  search, the shuffles, the token loads and the staging writes), ``fill``
  (the 255 stores), ``store`` (step 4's token words).
- K4's sections (:data:`SECTIONS2`) carry the same names and bits over its
  own steps: ``globals``, ``winread`` (level 2's grid loads), ``count``
  (level 3's count loads; the rank-slot writes stay), ``scan`` (the warp
  scan in rank order), ``copy``, ``fill``, ``store``.

The stubs keep every later index in range and the later sections' work near
the render's. A stubbed window read puts a block of 1-3 tokens in about one
cell in twelve (the combat render's mean is about 0.2 tokens a cell), and
nothing outside the map. Otherwise: global bytes ``i + a``; one slot for
each lane of the scan that holds a token (a ballot in place of the scan;
the slot takes the first token of the lane's first cell that has one);
each cell's first slot only, as (loc, block id, count); the fill's first
three bytes only; token words of a pattern, byte ``(k + p) & 255`` in word
k of flat agent p's row, read from no staging row.

K4's rank slot r holds, at one pass, what K1's scan cell r holds (the r-th
cell of the center-out walk), lane l the slots 4l .. 4l + 3 as K1's lane l
its cells, and K4's stubs are K1's with the rank slot for K1's scan index:
the two ablations are one function of the inputs, and
:func:`render_obs2_ablated_plain` is :func:`render_obs3_ablated_plain` on
the walk that the rank table describes.

Where a variant's slots overlap, or a byte is never written (the stubbed
copy and fill leave gaps; the staging row keeps the previous agent's
bytes), the kernel leaves bytes no plain version can know. The plain
versions return, beside the output, the mask of the bytes the variant
defines: a byte of the staging row written exactly once in its phase, and
every output byte a store writes from defined bytes or from no staging byte
at all.
"""

from __future__ import annotations

import ctypes

import torch

from metta_tpu_torch.ops.build import check_tensor

SECTIONS3 = ("globals", "winread", "count", "scan", "copy", "fill", "store")
SECTIONS2 = SECTIONS3       # K4's (csrc/obs_render2.cu), the same names and bits
EMPTY = 255
PASS = 128                  # window cells a pass takes (csrc/obs_render{3,2}.cu:kPass)

# Launches of the two ablation kernels, counted by the wrappers where they launch.
launches_obs3 = 0
launches_obs2 = 0


def variants(sections):
    """The ablation's variants: ``none``, each section alone, and all of them."""
    return ["none", *sections, "+".join(sections)]


def skips_of(variant: str, sections):
    """The set of sections a variant name (``none`` or ``a+b+...``) stubs."""
    skips = set() if variant == "none" else set(variant.split("+"))
    unknown = skips - set(sections)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}; known: {sections}")
    return skips


def mask_of(skips, sections) -> int:
    return sum(1 << sections.index(name) for name in skips)


def _apply(slots, vals, valid, R):
    """One phase of byte writes into an [E, A, R] row -> (bytes, defined): a
    byte written once takes its value and is defined; one written more than
    once, or never, is not."""
    E, A = slots.shape[:2]
    idx = torch.where(valid, slots, R).reshape(E, A, -1)
    cnt = torch.zeros((E, A, R + 1), dtype=torch.int32, device=slots.device)
    cnt.scatter_add_(2, idx, torch.ones_like(idx, dtype=torch.int32))
    new = torch.zeros((E, A, R + 1), dtype=torch.uint8, device=slots.device)
    new.scatter_(2, idx, vals.reshape(E, A, -1))
    return new[..., :R], cnt[..., :R] == 1


def _stub_blocks(E, A, S, NB, dev):
    """The stubbed window read: block ids as a function of (e, a, s)."""
    h = (torch.arange(E, device=dev)[:, None, None] + torch.arange(A, device=dev)[None, :, None]
         + torch.arange(S, device=dev))
    return torch.where((h % 12 == 0) & (NB > 1), 1 + h % max(NB - 1, 1), 0)


def render_obs3_ablated_plain(skips, sb, tok, counts, rc, g_count, g_tok, scan,
                              num_tokens: int, ohr: int, owr: int):
    """K1 with the sections in ``skips`` stubbed, in torch ops, step for step
    as ``csrc/obs_render3.cu`` takes them -> (out [E, A, T, 3] uint8,
    defined [E, A, T, 3] bool); undefined bytes are 0. With no skips it is
    ``render_obs3_plain``, every byte defined. ``out`` is taken to be
    16-byte aligned, as the wrapper requires: row p starts ``3 T p & 3``
    bytes past a word boundary."""
    skips = set(skips)
    E, H, W = sb.shape
    A = rc.shape[1]
    NB, K = tok.shape[1], tok.shape[2]
    S, G, T = scan.shape[0], g_tok.shape[2], num_tokens
    R, dev = 3 * T, sb.device
    s = torch.arange(S, device=dev)
    a_idx = torch.arange(A, device=dev)
    p = torch.arange(E, device=dev)[:, None] * A + a_idx                  # [E, A] flat agent
    gc = g_count.long().clamp(max=T)

    # the staging row, one phase: the global tokens' bytes, then the object slots
    gi = torch.arange(3 * G, device=dev)
    gvals = ((gi + a_idx[:, None]) & 255).expand(E, A, -1) if "globals" in skips \
        else g_tok.reshape(E, A, 3 * G).long()
    pos, vals, valid = [gi.expand(E, A, -1)], [gvals], [gi < 3 * gc[..., None]]

    # step 1: each cell's block id (-1 outside the map) and count
    if "winread" in skips:
        b = _stub_blocks(E, A, S, NB, dev)
    else:
        rr, cc = rc[..., 0:1].long() + scan[:, 0].long(), rc[..., 1:2].long() + scan[:, 1].long()
        inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
        flat = (rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)).reshape(E, -1)
        b = torch.where(inb, sb.reshape(E, -1).gather(1, flat).reshape(E, A, S).long(), -1)
    if "count" in skips:
        n = torch.where(b > 0, torch.clamp(1 + (b + s) % 3, max=K), 0)
    else:
        n = torch.where(b >= 0, counts.gather(1, b.clamp(min=0).reshape(E, -1))
                        .reshape(E, A, S).long(), 0)
    b = b.clamp(min=0)

    # steps 2-3, pass by pass of 128 cells, lane l holding cells 4l .. 4l + 3
    P = (S + PASS - 1) // PASS
    pad = P * PASS - S
    nP = torch.nn.functional.pad(n, (0, pad)).reshape(E, A, P, 32, 4)
    bP = torch.nn.functional.pad(b, (0, pad)).reshape(E, A, P, 32, 4)
    loc = torch.nn.functional.pad(((((scan[:, 0].long() + ohr) << 4)
                                    | (scan[:, 1].long() + owr)) & 255), (0, pad))
    local = nP.sum(-1)                                                   # [E, A, P, 32]
    held = (local > 0).long() if "scan" in skips else local               # slots a lane takes
    total = held.sum(-1)                                                 # [E, A, P]
    carry = total.cumsum(-1) - total
    first = carry[..., None] + held.cumsum(-1) - held                    # [E, A, P, 32]
    stop = torch.minimum(carry + total, (T - gc)[..., None])             # [E, A, P]
    cstart = first[..., None] + nP.cumsum(-1) - nP                       # each cell's first slot
    cell = torch.arange(P * PASS, device=dev).reshape(P, 32, 4)
    tok_flat = tok.reshape(E, NB * K, 2).long()

    def token(cells, t):
        """(loc, feat, val) of token t of the block in each of the cells
        [E, A, N] -> [E, A, N, 3]."""
        blk = bP.reshape(E, A, -1).gather(2, cells)
        ft = tok_flat.gather(1, (blk * K + t).reshape(E, -1, 1).expand(-1, -1, 2))
        return torch.cat([loc[cells][..., None], ft.reshape(E, A, -1, 2)], -1)

    if "copy" in skips:                   # each cell's first slot: (loc, block id, count)
        slot = cstart
        ok = (nP > 0) & (cstart < stop[..., None, None])
        v = torch.stack([loc[cell].expand_as(bP), bP & 255, nP & 255], -1)
    elif "scan" in skips:                 # lane l's one slot: its first cell with tokens
        k0 = (nP > 0).long().argmax(-1)                                  # [E, A, P, 32]
        slot = first
        ok = (local > 0) & (first < stop[..., None])
        cells = (cell[..., 0] + k0).reshape(E, A, -1)
        v = token(cells, torch.zeros_like(cells)).reshape(E, A, P, 32, 3)
    else:                                 # every token t of a cell at its first slot + t
        t = torch.arange(K, device=dev)
        slot = cstart[..., None] + t
        ok = (t < nP[..., None]) & (slot < stop[..., None, None, None])
        cells = cell[..., None].expand(E, A, P, 32, 4, K).reshape(E, A, -1)
        v = token(cells, t.expand(E, A, P, 32, 4, K).reshape(E, A, -1)).reshape(*slot.shape, 3)
    byte = 3 * (gc.reshape(E, A, *[1] * (slot.dim() - 2)) + slot)[..., None] \
        + torch.arange(3, device=dev)
    pos.append(byte.reshape(E, A, -1))
    vals.append(v.reshape(E, A, -1))
    valid.append(ok[..., None].expand(*ok.shape, 3).reshape(E, A, -1))
    st, st_ok = _apply(torch.cat(pos, -1), torch.cat(vals, -1).to(torch.uint8),
                       torch.cat(valid, -1), R)

    # step 4 and the fill: the token words end at tend, the fill starts there
    filled = (gc + total.sum(-1)).clamp(max=T)[..., None]                # [E, A, 1]
    mis = ((p * R) & 3)[..., None]
    n_words = (3 * filled + mis + 3) >> 2
    tend = 4 * n_words - mis
    i = torch.arange(R, device=dev)
    words = i < tend
    if "store" in skips:
        v1, ok1 = ((i + mis) >> 2) + p[..., None], torch.ones_like(words)
    else:
        tokens = i < 3 * filled
        v1, ok1 = torch.where(tokens, st.long(), EMPTY), torch.where(tokens, st_ok, True)
    if "fill" in skips:
        rest = (i >= tend) & (i < tend + 3)
        v2 = filled + i - tend
    else:
        rest, v2 = i >= tend, torch.full_like(i, EMPTY)
    out = torch.where(words, v1, v2) & 255
    defined = (words & ok1) | rest
    out = torch.where(defined, out, 0).to(torch.uint8)
    return out.reshape(E, A, T, 3), defined.reshape(E, A, T, 3)


def check_one_pass(wh: int, ww: int):
    """Raise ValueError past one pass of window cells: K4's stubs are
    written for one pass (``csrc/obs_render2.cu``)."""
    if not 1 <= wh * ww <= PASS:
        raise ValueError(f"window cells: K4's ablation takes 1 to {PASS} (one pass), "
                         f"got {wh}x{ww}")


def walk_of_rank(rank, wh: int, ww: int):
    """[S, 2] int32: the window offsets (dr, dc) of the center-out walk that
    the rank table describes (the cell of rank r at row r), K1's ``scan``."""
    s = torch.arange(wh * ww, device=rank.device)
    off = torch.stack([s // ww - wh // 2, s % ww - ww // 2], -1).to(torch.int32)
    return torch.empty_like(off).index_copy_(0, rank.long(), off)


def render_obs2_ablated_plain(skips, sb, tok, counts, rc, g_count, g_tok, rank,
                              num_tokens: int, wh: int, ww: int):
    """K4 with the sections in ``skips`` stubbed, in torch ops, step for step
    as ``csrc/obs_render2.cu`` takes them at one pass -> (out [E, A, T, 3]
    uint8, defined [E, A, T, 3] bool); undefined bytes are 0. Its counts by
    rank slot are K1's by scan cell, so it is K1's plain version on the walk
    of ``rank``. With no skips it is ``render_obs2_plain``, every byte
    defined."""
    check_one_pass(wh, ww)
    return render_obs3_ablated_plain(skips, sb, tok, counts, rc, g_count, g_tok,
                                     walk_of_rank(rank, wh, ww), num_tokens, wh // 2, ww // 2)


def render_work(args, scan, T):
    """What the render (K1, and K4, the same function) must do for these
    inputs: (bytes, operations, parts in bytes).

    Each output byte is written once. Each input byte the render needs is
    read once: the distinct grid cells of the windows up to the cell that
    fills the T slots (the walk stops there), the count of each distinct
    block those cells hold and the tokens taken from it, the agents'
    positions, global-token counts and global tokens, the window offsets.
    Operations: one add per walked cell (the prefix sum) and one select per
    output slot."""
    sb, tok, counts, rc, g_count, g_tok = args
    E, H, W = sb.shape
    A, NB, S = rc.shape[1], tok.shape[1], scan.shape[0]
    rr = rc[..., 0:1].long() + scan[:, 0].long()                        # [E, A, S]
    cc = rc[..., 1:2].long() + scan[:, 1].long()
    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    flat = (rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)).reshape(E, -1)
    b = torch.where(inb, sb.reshape(E, -1).gather(1, flat).reshape(E, A, S), 0).long()
    n = counts.gather(1, b.reshape(E, -1)).reshape(E, A, S).long()
    g = g_count.long().clamp(max=T)[..., None]
    free = T - g - (n.cumsum(-1) - n)                 # slots left on reaching the cell
    walked = inb & (free > 0)
    taken = torch.where(walked, torch.minimum(n, free), 0)
    cells = torch.zeros((E, H * W + 1), dtype=torch.int8, device=sb.device)
    cells.scatter_(1, torch.where(walked, flat.reshape(E, A, S), H * W).reshape(E, -1), 1)
    cells = cells[:, :H * W]                          # the spare column takes the unwalked
    blocks = torch.zeros((E, NB), dtype=torch.int64, device=sb.device)
    blocks.scatter_reduce_(1, b.reshape(E, -1), torch.where(walked, taken + 1, 0).reshape(E, -1),
                           reduce="amax")             # 1 + tokens taken, 0 = unread
    parts = {
        "grid": 4 * int(cells.sum()),
        "counts": 4 * int((blocks > 0).sum()),
        "tokens": 2 * int((blocks - 1).clamp(min=0).sum()),
        "rc+gcnt": 12 * E * A,
        "gtok": 3 * int(g.sum()),
        "scan": 8 * S,
        "out": 3 * E * A * T,
    }
    ops = int(walked.sum()) + E * A * T
    return sum(parts.values()), ops, parts


def _checked_out(out, E, A, T, device):
    if out is None:
        return torch.zeros((E, A, T, 3), dtype=torch.uint8, device=device)
    check_tensor("out", out, torch.uint8, (E, A, T, 3), device)
    if out.data_ptr() % 16:
        raise ValueError("out must be 16-byte aligned")
    return out


_entries = {}


def _entry(library: str, name: str, n_ints: int):
    """The ctypes function ``name`` of kernel library ``library``."""
    if name not in _entries:
        from metta_tpu_torch.ops.build import load_library

        fn = getattr(load_library(library), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        _entries[name] = fn
    return _entries[name]


def render_obs3_ablated(skips, sb, tok, counts, rc, g_count, g_tok, scan, num_tokens: int,
                        ohr: int, owr: int, out=None):
    """K1 with the sections in ``skips`` stubbed -> [E, A, T, 3] uint8, into
    ``out`` if given, else into a zeroed tensor. The CUDA kernel for CUDA
    tensors, the plain version's output for CPU tensors."""
    global launches_obs3
    skips = set(skips)
    mask = mask_of(skips, SECTIONS3)
    if sb.device.type == "cpu":
        return render_obs3_ablated_plain(skips, sb, tok, counts, rc, g_count, g_tok, scan,
                                         num_tokens, ohr, owr)[0]
    from metta_tpu_torch.ops import obs_render3 as k1

    E, H, W = sb.shape
    A = rc.shape[1]
    NB, K = tok.shape[1], tok.shape[2]
    S, G, T = scan.shape[0], g_tok.shape[2], num_tokens
    k1.check_inputs(sb, tok, counts, rc, g_count, g_tok, scan)
    out = _checked_out(out, E, A, T, sb.device)
    if E == 0:
        return out
    with torch.cuda.device(sb.device):
        err = _entry("obs_render3", "obs_render3_ablate_launch", 12)(
            sb.data_ptr(), tok.data_ptr(), counts.data_ptr(), rc.data_ptr(),
            g_count.data_ptr(), g_tok.data_ptr(), scan.data_ptr(), out.data_ptr(),
            E, H, W, A, NB, K, S, G, T, ohr, owr, mask,
            torch.cuda.current_stream(sb.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"obs_render3 ablation (mask {mask}) launch failed: CUDA error {err}")
    launches_obs3 += 1
    return out


def render_obs2_ablated(skips, sb, tok, counts, rc, g_count, g_tok, rank, num_tokens: int,
                        wh: int, ww: int, out=None):
    """K4 with the sections in ``skips`` stubbed -> [E, A, T, 3] uint8, into
    ``out`` if given, else into a zeroed tensor. The CUDA kernel for CUDA
    tensors, the plain version's output for CPU tensors; a window past one
    pass is refused before either."""
    global launches_obs2
    skips = set(skips)
    mask = mask_of(skips, SECTIONS2)
    check_one_pass(wh, ww)
    if sb.device.type == "cpu":
        return render_obs2_ablated_plain(skips, sb, tok, counts, rc, g_count, g_tok, rank,
                                         num_tokens, wh, ww)[0]
    from metta_tpu_torch.ops import obs_render2 as k4

    E, H, W = sb.shape
    A = rc.shape[1]
    NB, K = tok.shape[1], tok.shape[2]
    G, T = g_tok.shape[2], num_tokens
    k4.check_inputs(sb, tok, counts, rc, g_count, g_tok, rank, wh, ww, T)
    out = _checked_out(out, E, A, T, sb.device)
    if E == 0:
        return out
    with torch.cuda.device(sb.device):
        err = _entry("obs_render2", "obs_render2_ablate_launch", 11)(
            sb.data_ptr(), tok.data_ptr(), counts.data_ptr(), rc.data_ptr(),
            g_count.data_ptr(), g_tok.data_ptr(), rank.data_ptr(), out.data_ptr(),
            E, H, W, A, NB, K, wh, ww, G, T, mask,
            torch.cuda.current_stream(sb.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"obs_render2 ablation (mask {mask}) launch failed: CUDA error {err}")
    launches_obs2 += 1
    return out
