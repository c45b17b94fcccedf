"""Op declarations and registration: the site's "library inventory".

Declares the ABI of every logical op the JAX package declares — the same
signature text and minor versions (`repro/kernels/ops.py`), so a bundle
built against either package names the same ABI strings — and registers
what this port implements:

  * a plain PyTorch reference (provider ``torch-ref``) for ``rmsnorm``,
    ``attention``, ``windowed_attention``, ``chunk_attention`` and
    ``decode_attention`` (the last two in their contiguous and paged, full
    and windowed, full-precision and quantized-KV forms), ``moe_gmm``
    (`moe_gmm_ref`: dropless at <= 1024 rows, the capacity-truncated
    baseline above, as in the JAX package) and ``quant_matmul`` (int8 or
    fp8 weight codes with per-output-channel scales) and ``ssd_scan`` (the
    Mamba-2 chunked scan, `ssd_scan_ref`);
  * the hand-written CUDA kernels (provider ``cuda``) for the same eight,
    behind the ``cuda_kernels`` platform feature (``moe_gmm``'s is
    dropless at any row count).  Binding one builds the kernel library.

Every declared op is ported, in every form the JAX package's kernels
take.
"""

from __future__ import annotations

from repro_torch.core.abi import AbiString
from repro_torch.core.platform import CUDA_KERNELS
from repro_torch.core.registry import ImplKind, OpImpl, OpRegistry, global_registry
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_ref import (
    attention_ref,
    chunk_attention_ref,
    decode_attention_ref,
    windowed_attention_ref,
)
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.moe_gmm_ref import moe_gmm_ref
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.quant_matmul_ref import quant_matmul_ref
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.rmsnorm_ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan_ref import ssd_scan_ref

__all__ = ["ABIS", "OP_NAMES", "PORTED_OPS", "register_all"]

# Canonical signatures, copied verbatim from the JAX package (the quantized
# and paged forms ride the optional trailing args that the minors below
# record, not the signature text): the structural part of the ABI string.
# Changing a signature (or the semantic major version) makes old native
# kernels un-swappable — the registry will refuse, like Shifter on a
# libtool mismatch.
_SIGS = {
    "rmsnorm": {
        "args": ["x:[*,d]", "weight:[d]"],
        "kwargs": ["eps:float"],
        "semantics": "y = x/rms(x)*w, fp32 accumulation",
    },
    "attention": {
        "args": ["q:[b,sq,h,dh]", "k:[b,sk,kv,dh]", "v:[b,sk,kv,dh]"],
        "kwargs": ["causal:bool", "scale:float?"],
        "semantics": "softmax(qk^T*scale+causal_mask)v, GQA h%kv==0, fp32 softmax",
    },
    "decode_attention": {
        "args": ["q:[b,1,h,dh]", "k_cache:[b,smax,kv,dh]", "v_cache:[b,smax,kv,dh]", "pos:i32"],
        "kwargs": ["scale:float?"],
        "semantics": "single-token attention, cache slots > pos masked",
    },
    "windowed_attention": {
        "args": ["q:[b,sq,h,dh]", "k:[b,sk,kv,dh]", "v:[b,sk,kv,dh]", "window:i32"],
        "kwargs": ["scale:float?"],
        "semantics": ("sliding-window causal: query i attends keys in "
                      "(i-window, i], GQA h%kv==0, fp32 softmax"),
    },
    "chunk_attention": {
        "args": ["q:[b,c,h,dh]", "k_cache:[b,smax,kv,dh]", "v_cache:[b,smax,kv,dh]", "pos:i32"],
        "kwargs": ["scale:float?"],
        "semantics": "chunked prefill: query i attends cache keys <= pos+i",
    },
    "ssd_scan": {
        "args": ["x:[b,s,h,p]", "dt:[b,s,h]", "A:[h]", "B:[b,s,g,n]", "C:[b,s,g,n]"],
        "kwargs": ["chunk:int"],
        "semantics": "mamba2 SSD; returns (y, final_state[b,h,n,p] fp32)",
    },
    "moe_gmm": {
        "args": ["x:[t,d] sorted-by-expert", "w:[e,d,f]", "group_sizes:[e]"],
        "kwargs": [],
        # NB: this text feeds the signature digest, which must stay stable
        # across compatible revisions (a digest change strands every bundle
        # persisted under the old string) — behavioral refinements are
        # recorded as _ABI_MINORS bumps, not edits here.  Since minor 2 the
        # reference is dropless at decode scale (<=1k rows); above that it
        # remains the capacity-truncated baseline.
        "semantics": ("per-group matmul, groups partition rows of x; "
                      "capacity-truncated baseline, dropless native"),
    },
    "quant_matmul": {
        "args": ["x:[t,d]", "qw:[d,f] int8|fp8", "scale:[f] f32"],
        "kwargs": [],
        "semantics": ("y = x @ (qw * scale[None,:]) per output channel, "
                      "fp32 accumulation, output in x's dtype"),
    },
}

# Minor revisions: compatible extensions of a kernel (libtool "revision").
# A bump here leaves old bundles deployable (provider minor >= required
# minor) but expires the op's tuning-cache entries — they were measured
# on the previous kernel revision (see tuning/expiry.py).
#   moe_gmm 1: grew the k-loop contraction (block_k knob, D > 8k feasible)
#   moe_gmm 2: reference is dropless below _EXACT_ROWS_MAX rows (the
#              geometry-dependent capacity drop broke prefill/decode
#              consistency — docs/kernels.md)
#   decode_attention 1: pos may be (B,) as well as scalar — continuous
#              batching decodes every slot at its own position in one
#              call (the kernel grew per-batch kv_len rows in SMEM)
#   decode_attention 2 / chunk_attention 1: optional trailing
#              block_tables arg — k/v may be page pools (P, page, KV, Dh)
#              gathered through a per-batch block table; the kernel grew
#              per-batch block-index rows in the same SMEM meta
#              (docs/kernels.md "block-gather meta ABI")
#   decode_attention 3 / chunk_attention 2: optional trailing window arg
#              (traced () or (B,) i32) — sliding-window attention: keys
#              at logical positions <= pos - window (decode) /
#              <= pos + i - window (chunk) are masked, and whole
#              out-of-window k-blocks are skipped; the kernel grew a
#              per-batch window-start row in the same SMEM meta
#              (docs/kernels.md "window meta ABI")
#   decode_attention 4 / chunk_attention 3: optional trailing
#              k_scale/v_scale args (traced () or (B,) f32) — k/v caches
#              may be int8/fp8 quantized pools, dequantized in-kernel
#              after the VMEM upcast; the scales ride the same SMEM meta
#              as the kv_len/window rows, fp32 bits bitcast to int32
#              (docs/quantization.md "scale meta ABI")
_ABI_MINORS = {"moe_gmm": 2, "decode_attention": 4, "chunk_attention": 3}

ABIS: dict[str, AbiString] = {
    name: AbiString.make(name, sig, major=1, minor=_ABI_MINORS.get(name, 0))
    for name, sig in _SIGS.items()
}
OP_NAMES: tuple[str, ...] = tuple(sorted(ABIS))


# -- call-convention adapters (as repro/kernels/ops.py:136-204) --------------
def _cuda_attention(q, k, v, *, causal=True, scale=None):
    return flash_attention(q, k, v, causal=causal, scale=scale, op="attention")


def _cuda_windowed_attention(q, k, v, window, *, scale=None):
    # sliding-window causal prefill: the full-attention geometry plus a
    # window width — the wrapper adds the window-start row
    return flash_attention(q, k, v, window=window, causal=True, scale=scale,
                           op="windowed_attention")


def _cuda_decode_attention(q, k_cache, v_cache, pos, block_tables=None, window=None,
                           k_scale=None, v_scale=None, *, scale=None):
    # decode = flash with Sq=1 over the written prefix of the cache; with
    # block_tables the caches are page pools (page = the pool's second
    # dim); with window only the trailing `window` slots are attended;
    # with k_scale/v_scale the caches are int8/fp8 codes, dequantized in
    # the kernel's tile loader
    return flash_attention(q, k_cache, v_cache, kv_len=pos + 1, causal=False, scale=scale,
                           window=window, block_tables=block_tables, k_scale=k_scale,
                           v_scale=v_scale, op="decode_attention")


def _cuda_chunk_attention(q, k_cache, v_cache, pos, block_tables=None, window=None,
                          k_scale=None, v_scale=None, *, scale=None):
    # chunked prefill = flash with the causal diagonal re-anchored at pos:
    # query i (global position pos+i) sees cache keys <= pos+i, and the
    # kv_len mask hides slots past the chunk's own freshly written tail
    return flash_attention(q, k_cache, v_cache, kv_len=pos + q.shape[1], q_start=pos,
                           causal=True, scale=scale, window=window,
                           block_tables=block_tables, k_scale=k_scale, v_scale=v_scale,
                           op="chunk_attention")


def _ref_attention(q, k, v, *, causal=True, scale=None):
    # chunked (flash in plain torch) above 2k keys: same math, O(S) memory
    chunk = 1024 if k.shape[1] > 2048 else None
    return attention_ref(q, k, v, causal=causal, scale=scale, chunk_kv=chunk)


def _ref_windowed_attention(q, k, v, window, *, scale=None):
    return windowed_attention_ref(q, k, v, window, scale=scale)


_REFS = {
    "rmsnorm": rmsnorm_ref,
    "attention": _ref_attention,
    "windowed_attention": _ref_windowed_attention,
    "decode_attention": decode_attention_ref,
    "chunk_attention": chunk_attention_ref,
    "moe_gmm": moe_gmm_ref,
    "quant_matmul": quant_matmul_ref,
    "ssd_scan": ssd_scan_ref,
}

_NATIVES = {
    "rmsnorm": rmsnorm,
    "attention": _cuda_attention,
    "windowed_attention": _cuda_windowed_attention,
    "decode_attention": _cuda_decode_attention,
    "chunk_attention": _cuda_chunk_attention,
    "moe_gmm": moe_gmm,
    "quant_matmul": quant_matmul,
    "ssd_scan": ssd_scan,
}

PORTED_OPS: tuple[str, ...] = tuple(sorted(_REFS))

_registered: set[int] = set()


def register_all(registry: OpRegistry | None = None) -> OpRegistry:
    """Declare every op and register the ported implementations
    (idempotent per registry)."""
    reg = registry if registry is not None else global_registry
    if id(reg) in _registered:
        return reg
    for name in OP_NAMES:
        reg.declare(ABIS[name])
        if name not in _REFS:
            continue
        reg.register(OpImpl(abi=ABIS[name], kind=ImplKind.REFERENCE, fn=_REFS[name],
                            provider="torch-ref"))
        reg.register(OpImpl(abi=ABIS[name], kind=ImplKind.NATIVE, fn=_NATIVES[name],
                            requires_feature=CUDA_KERNELS, provider="cuda",
                            prepare=_build.library))
    _registered.add(id(reg))
    return reg

