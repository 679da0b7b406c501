"""Single-device Pippenger stages: batch accumulation and bucket reduction.

The counterpart of the JAX package's `ops/pippenger.py`:

1. `compute_digits`: window split, sign flag in bit 31.
2. `accumulate_batch` / `accumulate_buckets`: one batch of Niels planes,
   or a loop over batches, each added to a bucket carry; `accumulate_rows`
   takes a batch already packed into the scan's rows (`pack_rows`), as
   the wire path's `to_niels_xy_rows` kernel leaves it. Each batch is
   `_accumulate_batch`: a stable sort of each window's bucket ids, the
   `accumulate_scan_gather` kernel over C lanes of L steps per window
   (it gathers the packed point rows itself and leaves each bucket's
   in-lane partial sum), the `lane_scan` kernel (the segmented scan over
   lanes), a bucket histogram, and the `assemble_buckets` kernel (bucket
   assembly and the carry add in one launch).
3. `reduce_and_finish(bucket_sums, group_size=0)`: for Gs > 1 the grouped
   running sum (`grouped_running_sum` over the buckets of each group),
   then `reduce_finish` over the groups, which also doubles log2(Gs)
   times, adds and leaves the Montgomery domain; for Gs 1 the log-depth
   suffix scan `_suffix_weighted` (one `padd_masked` launch a level) and
   a plain `from_mont`. `reduce_buckets` is its Montgomery-domain output.
   Gs 0 takes the JAX package's TPU rule (`group_size`): 16 or 32 for
   every supported window, 1 below 64 buckets. `accumulate_and_reduce`
   (and its JAX name `msm_window_sums`) is 2 then 3 over points already
   on the device.
4. `_tree_sum_axis`: a log-depth group sum over a trailing axis, one
   `padd_masked` launch a level (the naive engine's sum of its products,
   and the tree combine of `parallel/msm_sharded.py`).

Point planes travel as int32 tensors of u32 bits; ids, digits and
positions are int64. Every point kernel goes through `ops/kernels`, which
runs the hand-written CUDA kernel on the card and its plain version on
the CPU.
"""
from __future__ import annotations

import torch

from . import field_ops, limbs, windows
from .kernels import padd_kernels as pk
from .kernels.padd_kernels import pack_rows  # the scan's row layout, [3, 16, M] -> [M, 24]


def n_buckets(window_size: int, signed_digits: bool) -> int:
    """Bucket-array width: 2^w unsigned; |digit| <= 2^(w-1) signed, padded
    to a multiple of 32 for the grouped reduction."""
    if not signed_digits:
        return 1 << window_size
    b = (1 << (window_size - 1)) + 1
    return -(-b // 32) * 32


def compute_digits(
    scalar_words: torch.Tensor, window_size: int, signed_digits: bool
) -> torch.Tensor:
    """[8, n] LE scalar words (int64) -> [K, n] int64 bucket ids, with the
    sign flag in bit 31 (packed in int64, so no int32 overflow)."""
    if signed_digits:
        buckets, sgn = windows.split_windows_signed(scalar_words, window_size)
        return buckets | (sgn << 31)
    return windows.split_windows(scalar_words, window_size)


def identity_buckets(window_size: int, signed_digits: bool, device="cpu") -> torch.Tensor:
    """Identity bucket array [4, 16, K, B] int32 (the batch loop's carry)."""
    shape = (windows.n_windows(window_size), n_buckets(window_size, signed_digits))
    return pk.identity_planes(shape, device)


def accumulate_batch(
    points_niels: torch.Tensor,  # [3, 16, M] int32 Montgomery Niels planes
    scalar_words: torch.Tensor,  # [8, M] int64 LE u32 words
    **kw,
) -> torch.Tensor:
    """One batch -> bucket sums [4, 16, K, B] int32 (Montgomery), added to
    `carry` (carry + sums) if one is given; the keywords of
    `accumulate_rows`."""
    return accumulate_rows(pack_rows(points_niels), scalar_words, **kw)


def accumulate_rows(
    rows: torch.Tensor,  # [M, 24] int32 packed Niels rows (`pack_rows`)
    scalar_words: torch.Tensor,  # [8, M] int64 LE u32 words
    *,
    window_size: int,
    n_chunks: int,
    chunk_len: int,
    signed_digits: bool = False,
    carry: torch.Tensor | None = None,  # [4, 16, K, B] int32
) -> torch.Tensor:
    """`accumulate_batch` over points already in the scan's row layout: the
    wire path's and the plan's batches."""
    digits = compute_digits(scalar_words, window_size, signed_digits)
    return _accumulate_batch(
        rows, digits, window_size, n_chunks, chunk_len,
        n_buckets(window_size, signed_digits), carry,
    )


def accumulate_buckets(
    points: torch.Tensor,  # [3, 16, n] int32 Montgomery Niels planes
    scalar_words: torch.Tensor,  # [8, n] int64 LE u32 words
    *,
    window_size: int,
    n_chunks: int,
    chunk_len: int,
    signed_digits: bool = False,
    carry: torch.Tensor | None = None,  # [4, 16, K, B] int32
) -> torch.Tensor:
    """Bucket sums [4, 16, K, B] of n points, n a multiple of the batch
    M = n_chunks * chunk_len (callers pad with identity points and zero
    scalars), added to `carry` if one is given. More than one batch runs as
    a loop that adds each batch's buckets into the carry (an identity one
    if none is given), so peak memory follows the batch."""
    M = n_chunks * chunk_len
    n = points.shape[-1]
    assert n % M == 0, (n, n_chunks, chunk_len)
    kw = dict(window_size=window_size, n_chunks=n_chunks, chunk_len=chunk_len,
              signed_digits=signed_digits)
    if n == M:
        return accumulate_batch(points, scalar_words, carry=carry, **kw)
    if carry is None:
        carry = identity_buckets(window_size, signed_digits, points.device)
    for b in range(n // M):
        sl = slice(b * M, (b + 1) * M)
        carry = accumulate_batch(points[..., sl].contiguous(), scalar_words[:, sl], carry=carry, **kw)
    return carry


def _accumulate_batch(
    rows: torch.Tensor,  # [M, 24] int32 packed Niels rows
    digits: torch.Tensor,  # [K, M] int64 bucket ids, sign flag in bit 31
    w: int,
    C: int,
    L: int,
    B: int,
    carry: torch.Tensor | None = None,  # [4, 16, K, B] int32
) -> torch.Tensor:
    """One batch -> bucket sums [4, 16, K, B] int32 (Montgomery), or
    carry + sums."""
    K = windows.n_windows(w)
    M = rows.shape[0]
    assert M == C * L, (M, C, L)
    W = K * C
    dev = rows.device

    # ---- sort each window's ids (stable, as lax.sort); sign bit not a key --
    keys = digits & 0x7FFFFFFF
    sorted_digits, perm = torch.sort(keys, dim=1, stable=True)
    sorted_packed = torch.gather(digits, 1, perm)

    # Step-major [L, K * C]: lane (k, c) scans sorted positions c*L + j.
    lanes = lambda t: limbs.as_i32(t).reshape(K, C, L).permute(2, 0, 1).reshape(L, W).contiguous()

    # The scan gathers the packed point rows (96 B a point) into run order
    # itself. partial: per bucket, the sum of its run's tail inside the lane
    # where the run ends (the identity where it ends at a lane edge, or is
    # empty).
    final_acc, final_id, partial = pk.accumulate_scan_gather(
        rows, lanes(perm), lanes(sorted_packed), K, B
    )
    # Segmented scan over lanes (runs crossing lane edges): at the last lane
    # of each equal-id segment, the segment's total.
    carries = pk.lane_scan(final_acc, final_id, K)

    # Bucket end positions (the first sorted index past bucket b) and the
    # histogram; each bucket takes the total of the lanes that its run covers
    # up to a lane edge. A binary search of the sorted ids: `torch.bincount`
    # would read its input's range back to the host, a sync every batch.
    buckets = torch.arange(B, device=dev).expand(K, B).contiguous()
    e_pos = torch.searchsorted(sorted_digits, buckets, right=True, out_int32=True)
    hist = torch.diff(e_pos, dim=1, prepend=torch.zeros((K, 1), dtype=torch.int32, device=dev))
    if carry is not None:
        carry = carry.reshape(4, 16, K * B)
    return pk.assemble_buckets(partial, carries, hist, e_pos, L, carry).reshape(4, 16, K, B)


def group_size(n_buckets: int) -> int:
    """The grouped reduction's Gs, by the TPU rule of the JAX package."""
    return 32 if n_buckets >= 1024 else (16 if n_buckets >= 64 else 1)


def _resolved_group_size(n_buckets: int, gs: int) -> int:
    """Gs for `reduce_and_finish`: 0 (or less) takes the TPU rule; any other
    Gs must be a power of two that divides B. (The JAX function asserts
    only the divisor: at Gs 3 it doubles once and returns a wrong sum.)"""
    if gs <= 0:
        gs = group_size(n_buckets)
    if gs & (gs - 1) or n_buckets % gs:
        raise ValueError(f"group_size {gs}: must be a power of two dividing {n_buckets} buckets")
    return gs


def reduce_and_finish(
    bucket_sums: torch.Tensor, group_size: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucket reduction W_k = sum_b b * S_b of [4, 16, K, B] int32 bucket
    sums -> window sums [4, 16, K] int32, (plain domain, Montgomery domain).

    Gs > 1: split b = g*Gs + r (G groups of Gs),

        W = Gs * sum_g g*T_g  +  sum_g U_g,
        T_g = sum_r S[g, r],  U_g = sum_r r * S[g, r].

    `grouped_running_sum` gives T and U for all K*G groups; `reduce_finish`
    sums g*T_g and U_g over each window's groups, doubles the first log2(Gs)
    times, adds the second and leaves the Montgomery domain.

    Gs 1: `_suffix_weighted` over the buckets, then a plain `from_mont`
    (the JAX package's XLA step there). `group_size` 0 takes the TPU rule.
    """
    K, B = bucket_sums.shape[-2], bucket_sums.shape[-1]
    Gs = _resolved_group_size(B, group_size)
    if Gs == 1:
        mont = _suffix_weighted(bucket_sums)
        plain = field_ops.from_mont(limbs.as_i64(mont).transpose(0, 1)).transpose(0, 1)
        return plain.to(torch.int32).contiguous(), mont
    G = B // Gs
    s = bucket_sums.reshape(4, 16, K * G, Gs).permute(3, 0, 1, 2).contiguous()
    T, U = pk.grouped_running_sum(s)  # [4, 16, K*G]
    return pk.reduce_finish(T, U, K, Gs.bit_length() - 1)


def reduce_buckets(bucket_sums: torch.Tensor, group_size: int = 0) -> torch.Tensor:
    """Window sums [4, 16, K] int64 in the Montgomery domain."""
    return limbs.as_i64(reduce_and_finish(bucket_sums, group_size)[1])


def accumulate_and_reduce(
    points: torch.Tensor,  # [3, 16, n] int32 Montgomery Niels planes
    scalar_words: torch.Tensor,  # [8, n] LE u32 words (int32 bits or int64)
    *,
    window_size: int,
    n_chunks: int,
    chunk_len: int,
    signed_digits: bool = False,
) -> torch.Tensor:
    """The whole pipeline on the points' device -> window sums [4, 16, K]
    int64 (Montgomery): `accumulate_buckets` with no carry (one batch adds
    into nothing, as in the JAX package; more batches into an identity
    carry), then `reduce_buckets`."""
    bucket_sums = accumulate_buckets(
        points, limbs.as_i64(scalar_words), window_size=window_size, n_chunks=n_chunks,
        chunk_len=chunk_len, signed_digits=signed_digits,
    )
    return reduce_buckets(bucket_sums)


# The JAX package's jitted entry, under its name: PyTorch runs eagerly, so
# there is nothing to compile.
msm_window_sums = accumulate_and_reduce


def _tree_sum_axis(st: torch.Tensor) -> torch.Tensor:
    """Group sum over the trailing axis in log depth: [4, 16, *batch, G]
    Montgomery points -> [4, 16, *batch], for any G; int32 planes (u32
    bits) give int32, int64 values give int64.

    The JAX package's roll loop: at level d = 1, 2, 4, ... < G, lane g
    becomes cur[g] + cur[g + d] where g + d < G (`padd_masked`, its own
    value first), so lane 0 ends with the sum; the same adds in the same
    order give the JAX digits. One `padd_masked` launch a level on the card.
    The naive engine sums its products with it, and the multi-GPU layer's
    `tree_add_points` its shards' partial sums.
    """
    G = st.shape[-1]
    if G == 1:
        return st[..., 0]
    shape = st.shape
    lane = torch.arange(G, device=st.device).expand(shape[2:])
    cur = (st if st.dtype == torch.int32 else limbs.as_i32(st)).reshape(4, 16, -1).contiguous()
    for i in range((G - 1).bit_length()):
        d = 1 << i
        shifted = torch.roll(cur.reshape(shape), -d, dims=-1).reshape(cur.shape)
        mask = (lane + d < G).to(torch.int32).reshape(-1)
        cur = pk.padd_masked(cur, shifted, mask)
    out = cur.reshape(shape)[..., 0]
    return out if st.dtype == torch.int32 else limbs.as_i64(out)


def _suffix_weighted(bucket_sums: torch.Tensor) -> torch.Tensor:
    """W = sum_b b * S_b over the trailing axis by log-depth suffix scans:
    [4, 16, *batch, B] int32 Montgomery points -> [4, 16, *batch] int32.

    The JAX package's order: ceil(log2 B) suffix levels (lane b becomes
    cur[b] + cur[b + d] where b + d < B, so it ends with sum_{b' >= b}
    S_b'), lane 0 set to the identity (bucket 0 has weight 0), then as many
    total levels (lane b becomes cur[b] + cur[b - d] where b >= d); lane
    B - 1 is the result. Each level is one `padd_masked` launch, the lane's
    own value first, on a plain `torch.roll`: the JAX digits.
    """
    shape = bucket_sums.shape
    B, dev = shape[-1], bucket_sums.device
    lane = torch.arange(B, device=dev).expand(shape[2:]).reshape(-1)
    cur = bucket_sums.reshape(4, 16, -1).contiguous()
    levels = max((B - 1).bit_length(), 1)

    def level(cur, shift, mask):
        shifted = torch.roll(cur.reshape(shape), shift, dims=-1).reshape(cur.shape)
        return pk.padd_masked(cur, shifted, mask.to(torch.int32))

    for i in range(levels):
        cur = level(cur, -(1 << i), lane + (1 << i) < B)
    cur = torch.where(lane == 0, pk.identity_planes((1,), dev), cur)
    for i in range(levels):
        cur = level(cur, 1 << i, lane >= 1 << i)
    return cur.reshape(shape)[..., B - 1].contiguous()
