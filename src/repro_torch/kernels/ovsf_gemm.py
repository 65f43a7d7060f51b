"""On-the-fly OVSF weight generation: the Hopper kernels and their plain
versions (port of ``repro.kernels.ovsf_gemm``, which holds both TPU kernels).

``ovsf_gemm(x, alphas, idx)`` computes y = x @ W with
W[k, n] = sum_j (-1)^popcount(idx[j] & k') * alphas[j, n] (see
``kernels.ref.ovsf_matmul_ref``); alphas are stored in x's type, or as int8
/ nibble-packed int4 with per-segment fp32 scales (``alpha_dtype``). On a
CUDA tensor it launches ``csrc/ovsf_gemm.cu`` (the port of the Pallas
``repro.kernels.ovsf_gemm:ovsf_gemm`` and its dequant epilogue; design and
bound in the source's header note) or raises; on a CPU tensor it runs the
plain version. The source holds three kernels, and ``route`` picks one per
call: "tensor_core" (bf16 x over segmented codes of length 16, every alpha
storage: the serving path), "mono_tc" (fp32 x and fp32 alphas over
monolithic codes whose stripe fits, ``mono_fits``: the CNN ``fused`` path;
its plan is ``mono_plan``) or "cuda_core" (the rest: fp32 x over segmented
codes, bf16 x or quantised alphas over monolithic codes, and the layouts the
tensor-core kernel does not take). ``ovsf_gemm.launches`` counts kernel
launches, ``ovsf_gemm.launches_by_alpha`` splits them by alpha storage
("fp", "int8", "int4") and ``ovsf_gemm.launches_by_kernel`` by kernel.

``ovsf_decompress(alphas, idx, d_in)`` materialises the dense W (d_in,
d_out) over (J,) monolithic or (n_seg, n_keep) segmented codes from
fp32/bf16 alphas, or from int8 / packed int4 alphas with per-segment fp32
scales (the Pallas kernel's dequant epilogue; W is then fp32):
``csrc/ovsf_decompress.cu`` (the port of the Pallas ``ovsf_decompress``:
``ovsf_decompress_kernel`` for monolithic codes, a WHT a column over
L = next_pow2(d_in), W returned as the transposed view of W^T;
``ovsf_decompress_seg_kernel`` for segmented ones, a register WHT of length
L0 = d_in / n_seg over a lane's adjacent columns, W written row-major, the
layout every LM config builds; segmented float alphas may carry a leading
batch, an MoE expert bank's (E, J, d_out), one launch for the bank, as the
reference vmaps ``decompress`` over it) on a CUDA tensor, its plain version
on a CPU tensor. ``ovsf_decompress.launches`` counts launches,
``ovsf_decompress.launches_by_layout`` splits them ("mono", "seg").
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.ovsf import dequantize_alphas, fwht, next_pow2
from repro_torch.kernels import build
from repro_torch.kernels.fwht import plan_args, wht_plan
from repro_torch.kernels.ref import ovsf_matmul_ref

# The plain PyTorch version of this kernel (CPU path and on-card reference).
ovsf_gemm_plain = ovsf_matmul_ref

# the CUDA-core kernel, as in the CUDA source
_BK = 64                      # k rows per k-block
_BN = 64                      # output columns per block
_BLOCKS_PER_SM = 2            # split-K target occupancy
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
_QUANT = {"": 0, "int8": 1, "int4": 2}

# the tensor-core kernel, as in the CUDA source (namespace tc)
KERNELS = ("tensor_core", "cuda_core", "mono_tc")
TC_SEG = 16                   # the code segment length it takes
TC_BK = 128                   # k rows per k-block: 8 code segments
TC_BN = 64                    # output columns per block
TC_MMAX = 256                 # rows of M per block; more go to M chunks
TC_MAX_NKEEP = 16
TC_MAX_SPLITS = 16
# columns in one 16-byte word of a stored alpha row, per storage
_TC_COLS = {"": 8, "int8": 16, "int4": 32}
# the split-K partials (fp32, written once and read once: 8 * M * N bytes a
# split) may move at most this share of the stored alpha bytes
TC_PARTIAL_SHARE = 4.0
_TC_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                + [ctypes.c_void_p])
_TICKETS: dict = {}           # device -> every ticket buffer, newest last


_DEC_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                 + [ctypes.c_void_p])
_DEC_MAX_L = 1 << 15          # the spectrum, L fp32, fits one block's 227 KB
_SEG_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                 + [ctypes.c_void_p])
DEC_MAX_L0 = 32               # the segmented kernel's register spectrum
# the segmented kernel, as in the CUDA source (namespace seg): a block's
# warps, and the blocks an SM holds (its persistent grid's, seg_plan)
SEG_WARPS = 8
SEG_BLOCKS_PER_SM = 2
# adjacent columns a block takes at least: one 16-byte fp32 (8-byte bf16)
# alpha load per id (8 bf16 columns, 16 bytes, were slower at d_in 1152 and
# 2304 on the H100: half the blocks)
DEC_TILE = 4
# id tensors whose range was checked: tensor -> ((its _version, L), distinct)
_CHECKED_IDS = WeakIdKeyDictionary()

# the monolithic tensor-core kernel, as in the CUDA source (namespace mono)
MONO_THREADS = 512
MONO_GROUP = 16               # rows of M a warp takes at a time
MONO_MAX_BN = 64              # output columns a stripe: 8 n8 tiles
MONO_MAX_L = 1 << 13          # a generation batch is THREADS * 32 elements
MONO_SMEM = 227 * 1024        # dynamic shared memory a block may opt in to
MONO_CLUSTER = 2              # blocks sharing a stripe's generation
_MONO_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 14
                  + [ctypes.c_void_p])


def tiling(M: int, K: int, N: int, n_sms: int) -> tuple[int, int, int]:
    """The CUDA-core kernel's (rows per block, k-blocks per split, splits):
    row tiles of 4/16/64, and the K range split until about two blocks per
    SM are in flight — decode (M = 4) has only N/64 column tiles to spread
    over the SMs."""
    bm = 4 if M <= 4 else 16 if M <= 16 else 64
    tiles = -(-M // bm) * -(-N // _BN)
    nkb = -(-K // _BK)
    want = max(1, min(nkb, -(-_BLOCKS_PER_SM * n_sms // tiles)))
    kb_per_split = -(-nkb // want)
    return bm, kb_per_split, -(-nkb // kb_per_split)


def route(x_dtype, seg: int, n_keep: int, alpha_dtype: str, N: int,
          rows_per_scale: int, K: int, J: int) -> str:
    """The kernel of one call, of three: "tensor_core" for bf16 x over
    segmented codes of length 16 with at most 16 kept codes a segment, where
    a stored alpha row of the tile is whole 16-byte words (N a multiple of
    8 / 16 / 32 for bf16 / int8 / int4) and a scale segment holds whole code
    segments; "mono_tc" for fp32 x with fp32 alphas over monolithic codes
    where a stripe of 8 columns fits a block (``mono_fits``; K = 4608, the
    CNNs' largest, does); "cuda_core" otherwise (fp32 x over segmented
    codes, bf16 x or quantised alphas over monolithic codes, and the rest).
    ``seg`` is 0 for monolithic codes; ``rows_per_scale`` is read for
    quantised alphas only."""
    if (x_dtype == torch.float32 and seg == 0 and not alpha_dtype
            and mono_fits(K, J)):
        return "mono_tc"
    if (x_dtype == torch.bfloat16 and seg == TC_SEG
            and 1 <= n_keep <= TC_MAX_NKEEP
            and N % _TC_COLS[alpha_dtype] == 0
            and (not alpha_dtype or rows_per_scale % n_keep == 0)):
        return "tensor_core"
    return "cuda_core"


def tc_blocks_per_sm(M: int) -> int:
    """Blocks of the tensor-core kernel one SM holds, as its ring's shared
    memory allows: 3 up to 64 rows of M, 2 up to 128, 1 above."""
    rows = min(M, TC_MMAX)
    return 3 if rows <= 64 else 2 if rows <= 128 else 1


def tc_plan(M: int, K: int, N: int, n_sms: int,
            alpha_bytes: int) -> tuple[int, int, int]:
    """(k-blocks per split, splits, M chunks) of the tensor-core kernel: one
    block per (M chunk of up to 256 rows, 64-column tile, split), each split
    a run of 128-row k-blocks. The K range is split as far as one wave of
    the card holds the blocks, and no further than keeps the partials
    (fp32, written and read once: 8 * M * N bytes a split) within
    ``TC_PARTIAL_SHARE`` of the stored alpha bytes, so large M splits
    little."""
    m_chunks = -(-M // TC_MMAX)
    tiles = m_chunks * -(-N // TC_BN)
    nkb = -(-K // TC_BK)
    wave = tc_blocks_per_sm(M) * n_sms // tiles
    cap = int(TC_PARTIAL_SHARE * alpha_bytes // (8 * M * N))
    splits = max(1, min(nkb, TC_MAX_SPLITS, wave, cap))
    per = -(-nkb // splits)
    return per, -(-nkb // per), m_chunks


def mono_pitch(K: int, J: int) -> int:
    """Bytes of one stripe row of the monolithic kernel: the column's J
    alphas (the stash) or its K (rounded up to 16) bf16 pairs, whichever is
    more, rounded to 64 mod 128 bytes so that a quarter-warp's two 64-byte
    row pieces fall in different bank halves."""
    row = -(-max(-(-K // 16) * 16, J) * 4 // 64) * 64
    return row + 64 if row % 128 == 0 else row


def mono_work_bytes(L: int, J: int) -> int:
    """Shared memory beside the stripe: the generation batch's spectra,
    THREADS * regs fp32 (64 regs at L = 64, 32 otherwise, as wht.cuh's
    stages), and the J code ids."""
    return MONO_THREADS * (64 if L == 64 else 32) * 4 + -(-J // 4) * 16


def mono_fits(K: int, J: int) -> bool:
    """Whether the monolithic kernel takes (K, J): L = next_pow2(K) within
    one generation batch, and a stripe of 8 columns beside the spectra and
    the ids in a block's shared memory (K = J = 4624 does, 4640 does not)."""
    L = next_pow2(K)
    return (1 <= K and 1 <= J and L <= MONO_MAX_L
            and 8 * mono_pitch(K, J) + mono_work_bytes(L, J) <= MONO_SMEM)


def mono_plan(M: int, K: int, N: int, J: int, n_sms: int) -> dict:
    """The monolithic kernel's plan: ``bn`` output columns a stripe (a
    multiple of 8, at most 64: the widest the stripe's shared memory allows,
    then narrowed to the least that keeps the stripe count), ``stripes``,
    ``cluster`` (``MONO_CLUSTER`` blocks on one stripe share its generation,
    where every stripe gets a cluster and a cluster has a 16-row group a
    block; else 1), ``blocks`` (one an SM: as many clusters as n_sms holds,
    no more than the stripes' row groups fill, at least one a stripe), the
    stripe row ``pitch`` and ``smem`` bytes. K is not split, so there are no
    partials; ``mono_block_rows`` gives each block's rows."""
    if not mono_fits(K, J):
        raise ValueError(f"ovsf_gemm: K={K}, J={J} outside the monolithic "
                         "kernel's stripe")
    L = next_pow2(K)
    pitch = mono_pitch(K, J)
    work = mono_work_bytes(L, J)
    bn_max = min(MONO_MAX_BN, (MONO_SMEM - work) // pitch // 8 * 8)
    stripes = -(-N // bn_max)
    bn = -(-(-(-N // stripes)) // 8) * 8
    groups = -(-M // MONO_GROUP)
    cluster = (MONO_CLUSTER if stripes * MONO_CLUSTER <= n_sms
               and groups >= MONO_CLUSTER else 1)
    clusters = max(stripes, min(n_sms // cluster,
                                stripes * (groups // cluster)))
    return dict(bn=bn, stripes=stripes, cluster=cluster,
                blocks=cluster * clusters, pitch=pitch,
                smem=bn * pitch + work, L=L)


def mono_block_rows(plan: dict, M: int, b: int) -> tuple[int, int, int]:
    """(stripe, first row, end row) of block b, as the kernel computes them:
    block b is rank r = b % cluster of cluster q = b // cluster, which takes
    stripe q % stripes; its chunk c = (q // stripes) * cluster + r takes an
    even share [c G / n, (c + 1) G / n) of the G 16-row groups, n the
    stripe's block count."""
    stripes, blocks, cluster = plan["stripes"], plan["blocks"], plan["cluster"]
    q, rank = divmod(b, cluster)
    sid = q % stripes
    chunk = q // stripes * cluster + rank
    mine = cluster * ((blocks // cluster - 1 - sid) // stripes + 1)
    groups = -(-M // MONO_GROUP)
    lo, hi = chunk * groups // mine, (chunk + 1) * groups // mine
    return sid, min(M, lo * MONO_GROUP), min(M, hi * MONO_GROUP)


def seg_cols(L0: int) -> int:
    """Adjacent columns a lane of the segmented kernel takes (its C x L0
    fp32 spectra live in registers): 4, or 2 at L0 = 32."""
    return 2 if L0 >= 32 else 4


def seg_plan(E: int, n_seg: int, N: int, L0: int, n_sms: int) -> dict:
    """The segmented kernel's work split: ``cols`` (C) columns a lane,
    ``tiles`` column tiles of 32 C a row, ``items`` = E n_seg tiles warp
    items (batch entry, segment, column tile), and the persistent grid's
    ``blocks``: ``SEG_BLOCKS_PER_SM`` an SM, fewer where the items fill
    fewer. Warp g of the grid takes items g, g + blocks SEG_WARPS, ...;
    item i is (batch entry, segment, column tile) = (i // (n_seg tiles),
    i // tiles % n_seg, i % tiles)."""
    C = seg_cols(L0)
    tiles = -(-N // (32 * C))
    items = E * n_seg * tiles
    blocks = max(1, min(-(-items // SEG_WARPS), SEG_BLOCKS_PER_SM * n_sms))
    return dict(cols=C, tiles=tiles, items=items, blocks=blocks)


def ticket_buffer(device, n: int) -> torch.Tensor:
    """At least n zeroed uint32 tickets on the device. Every kernel that
    merges its splits by ticket (the tensor-core ``ovsf_gemm``, both
    attention kernels) leaves them zero, so one buffer serves every launch
    on the stream. A CUDA graph replays the raw address it was captured
    with, so no buffer handed out is ever freed: a larger one is added
    beside the others. It cannot be added while a stream is being captured
    (its zeros would be written at the first replay, not now): an eager run
    of the largest shape sizes it first, as the step graphs' warm-up does."""
    bufs = _TICKETS.setdefault(device, [])
    if bufs and bufs[-1].numel() >= n:
        return bufs[-1]
    if (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(f"ticket_buffer: {n} tickets asked for under "
                           "CUDA-graph capture, more than the buffer holds; "
                           "run the shape eagerly before capturing it")
    bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32, device=device))
    return bufs[-1]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its storage offset breaks 16-byte words
    (under CUDA-graph capture the copy lives in the graph's pool, as long
    as the graph)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_scale(alpha_scale, J: int, device, who: str = "ovsf_gemm"
                 ) -> torch.Tensor:
    """The per-segment scales as the kernels read them: float32, contiguous,
    on the card beside the other operands, one per J // n_seg alpha rows."""
    if not isinstance(alpha_scale, torch.Tensor):
        raise ValueError(f"{who}: quantised alphas need an alpha_scale "
                         "tensor")
    if alpha_scale.dtype != torch.float32 or not alpha_scale.is_contiguous():
        raise ValueError(f"{who}: alpha_scale must be contiguous float32, "
                         f"got {alpha_scale.dtype}")
    if alpha_scale.device != device:
        raise ValueError(f"{who}: alpha_scale on {alpha_scale.device}, the "
                         f"other operands on {device}")
    n_seg = alpha_scale.numel()
    if n_seg <= 0 or J % n_seg:
        raise ValueError(f"{who}: J={J} alpha rows not divisible into "
                         f"{n_seg} scale segments")
    return alpha_scale


def ovsf_gemm(x: torch.Tensor, alphas: torch.Tensor, idx: torch.Tensor, *,
              alpha_scale=None, alpha_dtype: str = "") -> torch.Tensor:
    """y = x @ W(alphas, idx). x: (M, d_in) float32 or bfloat16; alphas:
    (J, d_out) in x's type, int8 (J, d_out) with ``alpha_dtype="int8"`` or
    packed int8 (J, d_out // 2) with ``"int4"`` (then ``alpha_scale`` holds
    the (n_seg, 1) float32 scales); idx: (J,) monolithic or (n_seg, n_keep)
    segmented int32 code ids -> (M, d_out) in x.dtype, accumulated in
    fp32."""
    if x.device.type == "cpu":
        return ovsf_gemm_plain(x, alphas, idx, alpha_scale=alpha_scale,
                               alpha_dtype=alpha_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ovsf_gemm: unsupported device {x.device}")
    if alpha_dtype not in _QUANT:
        raise ValueError(f"ovsf_gemm: unknown alpha_dtype {alpha_dtype!r}")
    if x.dim() != 2 or alphas.dim() != 2:
        raise ValueError(f"ovsf_gemm: x {tuple(x.shape)} and alphas "
                         f"{tuple(alphas.shape)} must be 2-D")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ovsf_gemm: x {x.dtype} must be float32 or "
                         "bfloat16")
    want = torch.int8 if alpha_dtype else x.dtype
    if alphas.dtype != want:
        raise ValueError(f"ovsf_gemm: alphas {alphas.dtype}, expected {want} "
                         f"for alpha_dtype {alpha_dtype!r} and x {x.dtype}")
    for name, t in (("alphas", alphas), ("idx", idx)):
        if t.device != x.device:
            raise ValueError(f"ovsf_gemm: {name} on {t.device}, x on "
                             f"{x.device}")
    M, K = x.shape
    J, N = alphas.shape
    if alpha_dtype == "int4":
        N *= 2                          # two nibbles per stored byte
    scale = (_check_scale(alpha_scale, J, x.device) if alpha_dtype
             else alphas)               # unread for unquantised alphas
    seg = n_keep = 0
    if idx.dim() == 2:
        ns, n_keep = idx.shape
        if ns * n_keep != J or K % ns:
            raise ValueError(f"ovsf_gemm: idx {tuple(idx.shape)} does not "
                             f"tile J={J} rows over d_in={K}")
        seg = K // ns
    elif idx.dim() != 1 or idx.shape[0] != J:
        raise ValueError(f"ovsf_gemm: idx {tuple(idx.shape)} vs J={J}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    rows_per_scale = J // scale.numel() if alpha_dtype else J
    kernel = route(x.dtype, seg, n_keep, alpha_dtype, N, rows_per_scale, K,
                   J)
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if kernel == "mono_tc":
        plan = mono_plan(M, K, N, J, n_sms)
        # on the caller's id tensor, whose version the check remembers
        distinct = _distinct_ids(idx, plan["L"], "ovsf_gemm")
    x = x.contiguous()
    alphas = alphas.contiguous()
    idx = idx.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if kernel == "mono_tc":
        x, alphas = _aligned(x), _aligned(alphas)
        err = build.launcher("ovsf_gemm", _MONO_ARGTYPES, "ovsf_gemm_mono")(
            x.data_ptr(), alphas.data_ptr(), idx.data_ptr(), out.data_ptr(),
            M, K, N, J, plan["L"], plan["bn"], plan["pitch"], plan["blocks"],
            plan["smem"], plan["cluster"], *_stages(plan["L"]), int(distinct),
            stream)
    elif kernel == "tensor_core":
        x, alphas, idx = _aligned(x), _aligned(alphas), _aligned(idx)
        per, splits, m_chunks = tc_plan(
            M, K, N, n_sms, alphas.numel() * alphas.element_size())
        partial = tickets = out        # unread with one split
        if splits > 1:
            partial = torch.empty((splits, M, N), dtype=torch.float32,
                                  device=x.device)
            tickets = ticket_buffer(x.device, m_chunks * -(-N // TC_BN))
        err = build.launcher("ovsf_gemm", _TC_ARGTYPES, "ovsf_gemm_tc")(
            x.data_ptr(), alphas.data_ptr(), scale.data_ptr(),
            idx.data_ptr(), out.data_ptr(), partial.data_ptr(),
            tickets.data_ptr(), M, K, N, J, n_keep,
            rows_per_scale // n_keep, per, splits, _QUANT[alpha_dtype],
            stream)
    else:
        bm, kb_per_split, splits = tiling(M, K, N, n_sms)
        partial = torch.empty((splits, M, N), dtype=torch.float32,
                              device=x.device)
        err = build.launcher("ovsf_gemm", _ARGTYPES)(
            x.data_ptr(), alphas.data_ptr(), scale.data_ptr(),
            idx.data_ptr(), out.data_ptr(), partial.data_ptr(), M, K, N, J,
            seg, n_keep, rows_per_scale, bm, splits, kb_per_split,
            int(x.dtype == torch.bfloat16), _QUANT[alpha_dtype], stream)
    if err:
        raise RuntimeError(f"ovsf_gemm: CUDA launch of the {kernel} kernel "
                           f"failed (cudaError {err})")
    ovsf_gemm.launches += 1
    ovsf_gemm.launches_by_alpha[alpha_dtype or "fp"] += 1
    ovsf_gemm.launches_by_kernel[kernel] += 1
    return out


def segmented_decompress_plain(alphas: torch.Tensor, idx: torch.Tensor,
                               d_in: int) -> torch.Tensor:
    """Dense (..., d_in, d_out) W of (n_seg, n_keep) segmented codes: each
    segment's kept alphas added into its length-L0 spectrum (repeated ids
    sum, as the reference's einsum does), then a per-segment WHT in the
    alphas' type, a rounding a butterfly stage as the reference's jnp;
    (..., J, d_out) alphas, any leading axes (an expert bank's E) sharing
    ``idx``."""
    ns, nk = idx.shape
    L0 = d_in // ns
    lead, d_out = alphas.shape[:-2], alphas.shape[-1]
    full = torch.zeros(lead + (ns, L0, d_out), dtype=alphas.dtype,
                       device=alphas.device)
    full.scatter_add_(-2, idx.long()[:, :, None].expand(
        lead + (ns, nk, d_out)), alphas.reshape(lead + (ns, nk, d_out)))
    # each segment's WHT along L0 in place: every stage's halves are whole
    # (h, d_out) blocks, so the butterflies run on contiguous rows
    return fwht(full, dim=-2).reshape(lead + (d_in, d_out))


def ovsf_decompress_plain(alphas: torch.Tensor, idx: torch.Tensor,
                          d_in: int, *, alpha_scale=None,
                          alpha_dtype: str = "") -> torch.Tensor:
    """The plain version of ``ovsf_decompress``: int8 / packed int4 alphas
    dequantised first (``core.ovsf.dequantize_alphas``: one fp32 multiply
    by the row's segment scale); segmented codes then run
    ``segmented_decompress_plain``; monolithic ones scatter-add each
    column's alphas into its length-L spectrum (repeated ids sum, as the
    Pallas kernel's sum over j does), WHT, crop, fp32 arithmetic, output in
    the alphas' type (fp32 for quantised alphas, as the Pallas kernel's);
    monolithic W as the (d_in, d_out) view of a (d_out, d_in) array,
    segmented W contiguous: the kernels' layouts."""
    if alpha_dtype:
        if not isinstance(alpha_scale, torch.Tensor):
            raise ValueError("ovsf_decompress: quantised alphas need an "
                             "alpha_scale tensor")
        alphas = dequantize_alphas(alphas, alpha_scale, alpha_dtype)
    if idx.dim() == 2:
        return segmented_decompress_plain(alphas, idx, d_in)
    L = next_pow2(d_in)
    spec = torch.zeros((alphas.shape[1], L), dtype=torch.float32,
                       device=alphas.device)
    spec.index_add_(1, idx.long(), alphas.float().t())
    return fwht(spec, dim=-1)[:, :d_in].to(alphas.dtype).t()


def _checked(idx: torch.Tensor, L: int):
    """``check_ids``' answer for this id tensor, version and L, or None
    (always for an inference tensor, which has no version counter)."""
    if idx.is_inference():
        return None
    hit = _CHECKED_IDS.get(idx)
    return hit[1] if hit is not None and hit[0] == (idx._version, L) else None


def _distinct_ids(idx: torch.Tensor, L: int, who: str) -> bool:
    """Whether no id repeats, after ``check_ids`` (raises on an id outside
    [0, L) before any launch). The check reads the ids on the host, which a
    stream being captured into a CUDA graph may not do: there an unchecked
    id tensor counts as repeating (the kernels' atomic scatter), and the
    kernels trap on an id out of range in any case."""
    if torch.cuda.is_current_stream_capturing():
        return bool(_checked(idx, L))
    return check_ids(idx, L, who)


def _stages(L: int) -> tuple:
    """(log2 regs, p2, p3) of the WHT body for rows of length L, as
    ``plan_args`` gives them, for the kernels' check against wht.cuh."""
    log2_regs, _rows, _threads, _smem, p2, p3 = plan_args(wht_plan(L, 4))
    return log2_regs, p2, p3


def check_ids(idx: torch.Tensor, L: int, who: str = "ovsf_decompress"
              ) -> bool:
    """Raise unless every code id lies in [0, L); return whether no id
    repeats. Reads the ids (one host sync) once per id tensor, its
    ``_version`` (an in-place edit bumps it) and L; the CNN convs pass the
    same id tensor every forward. An inference tensor (made under
    ``torch.inference_mode``) has no version, so its ids are read on every
    call. A write that bypasses the version counter (through ``.data``, or
    from outside PyTorch) is not seen: the kernel still traps on an id out
    of range, but a repeat it brings would be stored, not summed."""
    known = _checked(idx, L)
    if known is not None:
        return known
    if idx.numel() == 0:
        return True
    s = torch.sort(idx.flatten()).values
    lo, hi, repeats = (int(v) for v in torch.stack(
        [s[0], s[-1], (s[1:] == s[:-1]).sum()]).tolist())
    if lo < 0 or hi >= L:
        raise ValueError(f"{who}: code ids span [{lo}, {hi}], outside "
                         f"[0, {L})")
    if not idx.is_inference():
        _CHECKED_IDS[idx] = ((idx._version, L), repeats == 0)
    return repeats == 0


def ovsf_decompress(alphas: torch.Tensor, idx: torch.Tensor, d_in: int, *,
                    alpha_scale=None, alpha_dtype: str = "") -> torch.Tensor:
    """Dense W (d_in, d_out) = S^T @ alphas from (J, d_out) float32 or
    bfloat16 alphas (W in their type), or int8 (J, d_out) alphas with
    ``alpha_dtype="int8"`` / packed int8 (J, d_out // 2) with ``"int4"``
    and their (n_seg, 1) float32 ``alpha_scale``, J % n_seg == 0 (W fp32).
    ``idx``: (J,) monolithic code ids in [0, next_pow2(d_in)), S =
    H_L[idx, :d_in], W returned as the transposed view of a contiguous
    (d_out, d_in) array; or (n_seg, n_keep) segmented ids in [0, L0), L0 =
    d_in / n_seg a power of two up to ``DEC_MAX_L0``, n_keep <= L0, S
    block-diagonal (each segment's codes on its own L0 rows), W contiguous.
    Segmented float alphas may be a batch (E, J, d_out) sharing ``idx`` (an
    MoE expert bank): W (E, d_in, d_out), one launch."""
    if alphas.dim() == 3 and (idx.dim() != 2 or alpha_dtype):
        raise ValueError(f"ovsf_decompress: a batch of alphas "
                         f"{tuple(alphas.shape)} takes segmented ids and "
                         "float alphas (idx (n_seg, n_keep), no alpha_dtype)")
    if alphas.device.type == "cpu":
        return ovsf_decompress_plain(alphas, idx, d_in,
                                     alpha_scale=alpha_scale,
                                     alpha_dtype=alpha_dtype)
    if alphas.device.type != "cuda":
        raise ValueError(f"ovsf_decompress: unsupported device "
                         f"{alphas.device}")
    if alpha_dtype not in _QUANT:
        raise ValueError(f"ovsf_decompress: unknown alpha_dtype "
                         f"{alpha_dtype!r}")
    want = ((torch.int8,) if alpha_dtype
            else (torch.float32, torch.bfloat16))
    if alphas.dim() not in (2, 3) or alphas.dtype not in want:
        raise ValueError(f"ovsf_decompress: alphas {tuple(alphas.shape)} "
                         f"{alphas.dtype} must be 2-D (3-D: a batch) "
                         + ("int8" if alpha_dtype else "float32 or bfloat16")
                         + f" for alpha_dtype {alpha_dtype!r}")
    J, N = alphas.shape[-2:]
    if alpha_dtype == "int4":
        N *= 2                          # two nibbles per stored byte
    if (idx.dim() not in (1, 2) or idx.numel() != J
            or idx.dtype.is_floating_point or idx.device != alphas.device):
        raise ValueError(f"ovsf_decompress: idx {tuple(idx.shape)} "
                         f"{idx.dtype} on {idx.device} must be ({J},) or "
                         f"(n_seg, n_keep) integer code ids, {J} in all, "
                         "beside the alphas")
    scale = alphas                      # unread for float alphas
    if alpha_dtype:
        scale = _check_scale(alpha_scale, J, alphas.device, "ovsf_decompress")
    rows_per_scale = J // scale.numel() if alpha_dtype else J
    out_dtype = torch.float32 if alpha_dtype else alphas.dtype
    stream = torch.cuda.current_stream(alphas.device).cuda_stream
    if idx.dim() == 2:
        return _decompress_segmented(alphas, scale, idx, d_in, N,
                                     alpha_dtype, rows_per_scale, out_dtype,
                                     stream)
    L = next_pow2(d_in)
    if d_in < 1 or L > _DEC_MAX_L:
        raise ValueError(f"ovsf_decompress: d_in={d_in} outside "
                         f"1..{_DEC_MAX_L}")
    distinct = _distinct_ids(idx, L, "ovsf_decompress")
    alphas = _aligned(alphas.contiguous())
    idx = idx.to(torch.int32).contiguous()
    wt = torch.empty((N, d_in), dtype=out_dtype, device=alphas.device)
    plan = wht_plan(L, wt.element_size(), tile=DEC_TILE)
    err = build.launcher("ovsf_decompress", _DEC_ARGTYPES)(
        alphas.data_ptr(), scale.data_ptr(), idx.data_ptr(), wt.data_ptr(),
        J, N, d_in, L, int(alphas.dtype == torch.bfloat16),
        _QUANT[alpha_dtype], rows_per_scale, *plan_args(plan), int(distinct),
        stream)
    return _launched(err, "mono", wt).t()


def _decompress_segmented(alphas, scale, idx, d_in: int, N: int,
                          alpha_dtype: str, rows_per_scale: int, out_dtype,
                          stream) -> torch.Tensor:
    """``ovsf_decompress`` over (n_seg, n_keep) ids: the segmented kernel
    over (J, N) alphas or a batch (E, J, N) of them, W (d_in, N) or (E,
    d_in, N) row-major; no host read of the ids (the kernel traps on one
    outside [0, L0))."""
    ns, nk = idx.shape
    L0 = d_in // ns if ns else 0
    if (ns < 1 or d_in % ns or not 1 <= L0 <= DEC_MAX_L0 or L0 & (L0 - 1)
            or nk > L0):
        raise ValueError(f"ovsf_decompress: segmented idx {tuple(idx.shape)}"
                         f" over d_in={d_in}: L0 = d_in / n_seg must be a "
                         f"power of two up to {DEC_MAX_L0} and n_keep <= L0")
    E = alphas.shape[0] if alphas.dim() == 3 else 1
    alphas = _aligned(alphas.contiguous())
    idx = idx.to(torch.int32).contiguous()
    w = torch.empty(alphas.shape[:-2] + (d_in, N), dtype=out_dtype,
                    device=alphas.device)
    plan = seg_plan(E, ns, N, L0, torch.cuda.get_device_properties(
        alphas.device).multi_processor_count)
    err = build.launcher("ovsf_decompress", _SEG_ARGTYPES,
                         "ovsf_decompress_seg")(
        alphas.data_ptr(), scale.data_ptr(), idx.data_ptr(), w.data_ptr(),
        E, ns, nk, N, d_in, int(alphas.dtype == torch.bfloat16),
        _QUANT[alpha_dtype], rows_per_scale, plan["blocks"], stream)
    return _launched(err, "seg", w)


def _launched(err: int, layout: str, w: torch.Tensor) -> torch.Tensor:
    """Raise on a refused launch; else count it and return what the kernel
    wrote."""
    if err:
        raise RuntimeError(f"ovsf_decompress: CUDA launch of the {layout} "
                           f"kernel failed (cudaError {err})")
    ovsf_decompress.launches += 1
    ovsf_decompress.launches_by_layout[layout] += 1
    return w


def reset_launches() -> None:
    """Zero the launch counters (``ovsf_gemm``: total, per alpha storage and
    per kernel of ``KERNELS``; ``ovsf_decompress``: total and per layout)."""
    ovsf_gemm.launches = 0
    ovsf_gemm.launches_by_alpha = dict.fromkeys(("fp", "int8", "int4"), 0)
    ovsf_gemm.launches_by_kernel = dict.fromkeys(KERNELS, 0)
    ovsf_decompress.launches = 0
    ovsf_decompress.launches_by_layout = dict.fromkeys(("mono", "seg"), 0)


reset_launches()
