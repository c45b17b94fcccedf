"""The text decoder as an `nn.Module`: dense, mixture-of-experts or Mamba-2.

A port of the dense, MoE and SSM families of `repro/models/model.py`: the
same schema (embedding, a stack of [pre-norm, attention, post-norm,
SiLU-GLU MLP or MoE] blocks or of [pre-norm, Mamba-2 mixer] blocks, final
norm, LM head or the embedding tied as the head), the same cache layout
and the same serving entry points — `prefill`, `prefill_into` (chunked
prefill into one slot of a batched cache) and `decode` (one
continuous-batching tick), each over a contiguous cache (`init_cache`) or
a paged one (`init_paged_cache`: k/v page pools shared by all slots,
addressed through per-slot block tables; an SSM's state and conv tail
stay slot-indexed), with an optional sliding window for attention — plus
`export_paged_slot` / `import_paged_slot`, the KV handoff's page copy.

The JAX model scans one stacked parameter group over its blocks; here each
block is a module of an `nn.ModuleList` holding its own slice of the stack
(``decoder/p0/attn/wq[i]`` is ``layers.i.attn.wq``).  `Model.schema()` is
the JAX-shaped stacked tree, so shapes compare one to one.

The kernel ops run through `binding` (op name -> callable), which the
caller always passes — a deployed Container's binding; there is no
implicit one.  A MoE block (every block of a config with ``moe_every ==
1``: moonshot, phi3.5-moe) runs `repro_torch.models.moe.moe_apply` after
its post-norm, its grouped matmuls through ``binding["moe_gmm"]``.  An
SSM block (``family == "ssm"``: mamba2) runs
`repro_torch.models.ssm`, its scan through ``binding["ssd_scan"]``; its
decode freezes the state of rows that are not `active`.

Parameters are created on the meta device and bound by `load_params`
(weights from elsewhere, e.g. `repro_torch.convert.params_from_jax`) or
`init` (drawn from a seeded `torch.Generator` on the model's device).
The model takes its structure from the state it is given, as the JAX
model takes it from its parameter tree: a ``<leaf>.q`` / ``<leaf>.scale``
pair binds that leaf in storage form (int8 or fp8 codes, float32 scales
with axis -2 reduced away; what `checkpoint.manifest.quantize_tree` or a
quantized checkpoint gives).  The MLP and the LM head then run
``binding["quant_matmul"]``; the attention projections dequantize their
leaves, and the embedding dequantizes only the rows it gathers.  A tied
head (``tie_embeddings``: no ``lm_head``) is the embedding transposed,
dequantized whole when it is in storage form, as in JAX.

With ``kv_quantize="int8"|"fp8"`` the attention cache holds 1-byte
codes: k/v (pools) of int8 / float8_e4m3fn and ``k_scale``/``v_scale``
float32 rows of one static scale a slot (``KV_CALIBRATION_AMAX / top``),
slot-indexed even when paged.  Every write quantizes onto that grid, the
attention ops dequantize in their kernels, and the whole-prompt `prefill`
attends over full-precision k/v and returns the quantized cache.

Hybrid, encoder-decoder, vision, non-RMSNorm and interleaved-MoE
configurations are not ported: they raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.manifest import quantize_tree
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quant import FORMATS, FP8_MAX, INT8_MAX, storage_dtype
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_apply, moe_schema
from repro_torch.models.schema import LeafSpec, map_leaves, torch_dtype
from repro_torch.models.ssm import (ssm_apply, ssm_decode, ssm_init_cache_shapes,
                                    ssm_prefill_chunk, ssm_schema)

__all__ = ["KV_CALIBRATION_AMAX", "Model", "flatten_params", "tree_items"]

Tree = dict[str, Any]

# Static KV-cache calibration, the JAX model's constant: one amax for every
# slot (scale = amax / the format's top), so the (B,) scale rows are cache
# leaves that no step changes.
KV_CALIBRATION_AMAX = 8.0


def _stack(tree: Tree, n: int) -> Tree:
    return map_leaves(
        lambda _, s: dataclasses.replace(s, shape=(n,) + s.shape, axes=("layers",) + s.axes),
        tree,
    )


_CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)


def _meta(shape, dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"), requires_grad=False)


class _Leaves(nn.Module):
    """One parameter subtree: leaves by name, read as ``leaves["wq"]``; a
    nested subtree (the MoE's ``shared`` MLP) is a child `_Leaves`, and so
    is a leaf in storage form (``leaves["w_in"]["q"]``, ``["scale"]``)."""

    def __init__(self, specs: Mapping[str, Any], dtype: torch.dtype):
        super().__init__()
        self._specs, self._dtype = dict(specs), dtype
        for name, spec in specs.items():
            if isinstance(spec, Mapping):
                self.add_module(name, _Leaves(spec, dtype))
            else:
                self._place(name, spec)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def _place(self, name: str, spec: LeafSpec, codes: torch.dtype | None = None) -> None:
        """A meta placeholder for leaf `name`: the spec's shape and dtype,
        or, with a `codes` dtype, the storage-form pair (codes of the
        spec's shape, float32 scales with axis -2 removed)."""
        if name in self:
            delattr(self, name)
        if codes is None:
            self.register_parameter(
                name, _meta(spec.shape, torch_dtype(spec.dtype) if spec.dtype else self._dtype))
            return
        if codes not in _CODE_DTYPES or len(spec.shape) < 2:
            raise TypeError(f"{name}: codes of dtype {codes} for a leaf of shape {spec.shape} "
                            "(int8 or float8_e4m3fn, at least 2-d)")
        pair = _Leaves({}, self._dtype)
        pair.register_parameter("q", _meta(spec.shape, codes))
        pair.register_parameter("scale", _meta(spec.shape[:-2] + spec.shape[-1:],
                                               torch.float32))
        self.add_module(name, pair)

    def bind_structure(self, prefix: str, state: Mapping[str, torch.Tensor]) -> None:
        """Re-place every leaf as `state` holds it: in storage form where it
        has ``<prefix>.<leaf>.q`` and ``.scale``, else full precision."""
        for name, spec in self._specs.items():
            path = f"{prefix}.{name}"
            if isinstance(spec, Mapping):
                self._modules[name].bind_structure(path, state)
                continue
            q = state.get(path + ".q")
            self._place(name, spec, q.dtype if q is not None and path + ".scale" in state
                        else None)


class _Block(nn.Module):
    def __init__(self, specs: Tree, dtype: torch.dtype):
        super().__init__()
        for name, sub in specs.items():
            self.add_module(name, _Leaves(sub, dtype))


def flatten_params(tree: Tree) -> dict[str, torch.Tensor]:
    """JAX-layout parameter tree (``decoder/p0/*`` stacked over blocks) ->
    the port's state dict (``layers.{i}.*``), unstacking the block axis.
    The per-layer tensors are views of the stacked ones.  A storage-form
    leaf ``{"q", "scale"}`` becomes ``<leaf>.q`` and ``<leaf>.scale``
    (its scales are stacked too: axis -2 never is the block axis)."""
    state: dict[str, torch.Tensor] = {}
    for path, leaf in tree_items(tree):
        parts = path.split("/")
        if parts[0] == "decoder":
            if parts[1] != "p0":
                raise ValueError(f"one pattern position (period 1) is ported, got {path}")
            for i in range(leaf.shape[0]):
                state[".".join(["layers", str(i)] + parts[2:])] = leaf[i]
        else:
            state[".".join(parts)] = leaf
    return state


def tree_items(tree: Tree, prefix: str = ""):
    """(path, leaf) pairs of a nested parameter tree, paths "a/b/c"."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            yield from tree_items(v, path)
        else:
            yield path, v


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, binding, *, device: str | torch.device = "cuda",
                 kv_quantize: str | None = None):
        super().__init__()
        ssm = cfg.family == "ssm"
        if (cfg.family not in ("dense", "moe", "ssm") or cfg.norm != "rmsnorm"
                or cfg.activation != "silu_glu" or bool(cfg.ssm_state) != ssm
                or cfg.is_enc_dec or cfg.modality != "text"
                or (cfg.num_experts and cfg.moe_every != 1)):
            raise NotImplementedError(
                f"{cfg.name}: only dense, all-MoE or Mamba-2, RMSNorm + SiLU-GLU text "
                "decoders are ported")
        if kv_quantize is not None:
            if kv_quantize not in FORMATS:
                raise ValueError(f"kv_quantize must be one of {FORMATS}, got {kv_quantize!r}")
            if ssm:
                raise ValueError(f"{cfg.name}: an SSM has no KV cache to quantize")
        self.kv_quantize = kv_quantize
        # the cache's element type, and the scale every slot starts and stays at
        self.kv_dtype = storage_dtype(kv_quantize) if kv_quantize else torch_dtype(cfg.dtype)
        self.kv_scale_init = (None if kv_quantize is None else KV_CALIBRATION_AMAX / (
            INT8_MAX if kv_quantize == "int8" else FP8_MAX))
        self.cfg = cfg
        self.binding = binding
        self.device = torch.device(device)
        self.dtype = torch_dtype(cfg.dtype)
        # Megatron-style vocab padding to a multiple of 128, as the JAX model;
        # padded logit columns are masked
        self.padded_vocab = -(-cfg.vocab_size // 128) * 128
        self.num_blocks = cfg.num_layers
        layer = self._layer_schema()
        self.embed = _Leaves({"tok": self.schema()["embed"]["tok"]}, self.dtype)
        self.layers = nn.ModuleList(_Block(layer, self.dtype) for _ in range(self.num_blocks))
        self.final_norm = _Leaves(L.norm_schema(cfg), self.dtype)
        if not cfg.tie_embeddings:
            self.lm_head = _Leaves(self.schema()["lm_head"], self.dtype)

    # ------------------------------------------------------------------ #
    # schema and weights
    # ------------------------------------------------------------------ #
    def _layer_schema(self) -> Tree:
        cfg = self.cfg
        sch: Tree = {"pre_norm": L.norm_schema(cfg)}
        if cfg.is_attn_layer(0):
            sch["attn"] = L.attention_schema(cfg)
        else:
            sch["ssm"] = ssm_schema(cfg)
        if cfg.d_ff or cfg.num_experts:
            sch["post_norm"] = L.norm_schema(cfg)
            if cfg.is_moe_layer(0):
                sch["moe"] = moe_schema(cfg)
            else:
                sch["mlp"] = L.mlp_schema(cfg)
        return sch

    def schema(self) -> Tree:
        """The JAX model's schema tree (blocks stacked under decoder/p0)."""
        cfg = self.cfg
        sch: Tree = {
            "embed": {"tok": LeafSpec((self.padded_vocab, cfg.d_model), ("vocab", "embed"),
                                      scale=0.01)},
            "decoder": {"p0": _stack(self._layer_schema(), self.num_blocks)},
            "final_norm": L.norm_schema(cfg),
        }
        if not cfg.tie_embeddings:
            sch["lm_head"] = {"w": LeafSpec((cfg.d_model, self.padded_vocab),
                                            ("embed", "vocab"), init="scaled")}
        return sch

    def draw(self, generator: torch.Generator, quantize: str | None = None) -> Tree:
        """The JAX-layout parameter tree drawn from `generator` (on its
        device), leaf by leaf in schema order.  With `quantize` ("int8" or
        "fp8") each leaf `quantize_tree` picks is stored as codes and
        scales as it is drawn, so the peak is the codes plus one leaf."""
        dtype = torch_dtype(self.cfg.dtype)

        def leaf(path: str, spec: LeafSpec):
            t = spec.materialize(generator, dtype)
            return quantize_tree({path: t}, quantize)[path] if quantize else t

        return map_leaves(leaf, self.schema())

    def init(self, generator: torch.Generator, quantize: str | None = None) -> "Model":
        """Draw every parameter from `generator` (on the model's device),
        in storage form with `quantize` (`draw`)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        return self.load_params(flatten_params(self.draw(generator, quantize)))

    def load_params(self, state: Mapping[str, torch.Tensor]) -> "Model":
        """Bind a full state dict (``layers.{i}.attn.wq``, ...): each tensor
        is moved to the model's device and dtype (codes keep theirs, scales
        are float32), shapes must match.  A leaf given as ``<leaf>.q`` and
        ``<leaf>.scale`` is bound in storage form."""
        groups = [("embed", self.embed), ("final_norm", self.final_norm)]
        if not self.cfg.tie_embeddings:
            groups.append(("lm_head", self.lm_head))
        groups += [(f"layers.{i}.{name}", leaves) for i, blk in enumerate(self.layers)
                   for name, leaves in blk.named_children()]
        for prefix, leaves in groups:
            leaves.bind_structure(prefix, state)
        own = dict(self.named_parameters())
        missing, extra = set(own) - set(state), set(state) - set(own)
        if missing or extra:
            raise KeyError(f"state dict mismatch: missing {sorted(missing)[:4]}, "
                           f"unexpected {sorted(extra)[:4]}")
        bound = {}
        for name, p in own.items():
            t = state[name]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(p.shape)}")
            bound[name] = t.to(device=self.device, dtype=p.dtype)
        self.load_state_dict(bound, assign=True)
        return self

    # ------------------------------------------------------------------ #
    # caches
    # ------------------------------------------------------------------ #
    def _slot_leaves(self, batch: int) -> dict:
        """The per-slot leaves of the cache (an SSM's state and conv tail),
        stacked over the blocks: name -> (shape, dtype name)."""
        if self.cfg.family != "ssm":
            return {}
        return {name: ((self.num_blocks,) + shape, dt)
                for name, (shape, dt) in ssm_init_cache_shapes(self.cfg, batch).items()}

    def _kv_leaves(self, shape: tuple, slots: int) -> dict:
        """k/v of `shape` in the cache's element type, and with a quantized
        cache the (layers, slots) float32 scale rows."""
        dt = str(self.kv_dtype).removeprefix("torch.")
        leaves = {name: (shape, dt) for name in ("k", "v")}
        if self.kv_quantize:
            leaves.update({name: ((self.num_blocks, slots), "float32")
                           for name in ("k_scale", "v_scale")})
        return leaves

    def cache_shapes(self, batch: int, max_len: int) -> Tree:
        """Contiguous cache entry shapes, as the JAX model's: attention k/v
        (layers, B, max_len, KV, Dh) in the model dtype (or int8 / fp8 with
        (layers, B) scale rows), or an SSM's state (layers, B, H, N, P)
        float32 and conv tail (layers, B, conv-1, Din)."""
        if self.cfg.family == "ssm":
            return {"p0": self._slot_leaves(batch)}
        shape = (self.num_blocks, batch, max_len, self.cfg.num_kv_heads, self.cfg.head_dim)
        return {"p0": self._kv_leaves(shape, batch)}

    def init_cache(self, batch: int, max_len: int) -> Tree:
        """Cache ``{"p0": {...}}`` of `cache_shapes`: zeros, scale rows at
        the calibration."""
        return self._init_cache(self.cache_shapes(batch, max_len))

    def paged_cache_shapes(self, num_pages: int, page_size: int, slots: int) -> Tree:
        """Paged-cache entry shapes, as the JAX model's: attention k/v become
        page pools (layers, num_pages, page_size, KV, Dh) shared by all
        slots; an SSM's state and conv tail are O(1) a slot and stay
        slot-indexed (``slots`` rows) as in `cache_shapes`, and so do a
        quantized cache's scale rows."""
        if self.cfg.family == "ssm":
            return {"p0": self._slot_leaves(slots)}
        shape = (self.num_blocks, num_pages, page_size, self.cfg.num_kv_heads,
                 self.cfg.head_dim)
        return {"p0": self._kv_leaves(shape, slots)}

    def init_paged_cache(self, num_pages: int, page_size: int, slots: int) -> Tree:
        """Paged cache ``{"p0": {...}}`` of `paged_cache_shapes`: zeros,
        scale rows at the calibration."""
        return self._init_cache(self.paged_cache_shapes(num_pages, page_size, slots))

    def _init_cache(self, shapes: Tree) -> Tree:
        """Zeros, but the scale rows start at the calibration, as in JAX: a
        zero scale would blow up the first quantized write."""
        def fill(name: str) -> float:
            return self.kv_scale_init if name in ("k_scale", "v_scale") else 0

        return {pj: {name: torch.full(shape, fill(name), dtype=torch_dtype(dt),
                                      device=self.device)
                     for name, (shape, dt) in entry.items()}
                for pj, entry in shapes.items()}

    def export_paged_slot(self, cache: Tree, pages, slot: int) -> dict:
        """One slot's state out of a paged cache, as host numpy arrays.

        ``pages`` is the slot's leased page ids in block-table order (only
        the written prefix).  Keys are ``"p{j}/{leaf}"``: k/v yield
        ``(layers, len(pages), page_size, KV, Dh)`` page stacks and an SSM's
        leaves the slot's row ``(layers, ...)`` (so do a quantized cache's
        scale rows), as the JAX model exports them; bf16 and fp8 leaves
        export as float32 (exact), since numpy has neither.
        """
        ix = torch.as_tensor(np.asarray(pages, dtype=np.int64), device=self.device)
        out: dict = {}
        for pj, entry in cache.items():
            for name, buf in entry.items():
                stack = buf[:, ix] if name in ("k", "v") else buf[:, slot]
                if stack.dtype in (torch.bfloat16, torch.float8_e4m3fn):
                    stack = stack.float()
                out[f"{pj}/{name}"] = stack.cpu().numpy()
        return out

    def import_paged_slot(self, cache: Tree, arrays: Mapping[str, Any], pages,
                          slot: int) -> Tree:
        """Scatter an exported slot into this cache's own ``pages`` (same
        count, any ids) and, for an SSM's leaves, its row ``slot``, in
        place; returns the cache.  Every leaf is checked before any buffer
        is written."""
        ix = torch.as_tensor(np.asarray(pages, dtype=np.int64), device=self.device)
        staged = []
        for pj, entry in cache.items():
            for name, buf in entry.items():
                key = f"{pj}/{name}"
                if key not in arrays:
                    raise ValueError(f"paged-slot import: missing leaf {key}")
                src = np.asarray(arrays[key])
                paged = name in ("k", "v")
                want = ((buf.shape[0], len(pages)) if paged else (buf.shape[0],)) \
                    + tuple(buf.shape[2:])
                if src.shape != want:
                    raise ValueError(f"paged-slot import: {key} is {src.shape}, "
                                     f"{'target pages' if paged else 'slot row'} need {want}")
                if src.dtype.kind not in "fiu":   # e.g. ml_dtypes' bfloat16
                    src = src.astype(np.float32)
                staged.append((buf, (slice(None), ix if paged else slot),
                               np.require(src, requirements="W")))
        for buf, where, src in staged:
            buf[where] = torch.from_numpy(src).to(device=self.device, dtype=buf.dtype)
        return cache

    # ------------------------------------------------------------------ #
    # forward pieces
    # ------------------------------------------------------------------ #
    def _block(self, i: int, x: torch.Tensor, mode: str, lc=None, pos=None, positions=None,
               n_valid=None, active=None, **attn_kw):
        """One block.  The cache entries `lc` are updated in place; returns
        (x, the whole-prompt cache entries in "prefill" mode, else None)."""
        blk, cfg, binding = self.layers[i], self.cfg, self.binding
        h = L.norm_apply(blk.pre_norm, x, cfg, binding)
        kv = None
        if hasattr(blk, "ssm"):
            if mode == "decode":
                y, new = ssm_decode(blk.ssm, h, lc, cfg)
                if active is not None:
                    # a parked row must not advance: unlike a KV write, which
                    # lands where no live row reads, the recurrence would fold
                    # the dummy token into the row's state for good
                    new = {name: torch.where(active.view(-1, *(1,) * (t.dim() - 1)), t, lc[name])
                           for name, t in new.items()}
                for name, t in new.items():
                    lc[name].copy_(t)
            elif mode == "chunk":
                y, new = ssm_prefill_chunk(blk.ssm, h, lc, pos, n_valid, cfg, binding)
                for name, t in new.items():
                    lc[name].copy_(t)
            else:
                y, kv = ssm_apply(blk.ssm, h, cfg, binding, return_state=True)
        elif mode == "decode":
            y, _ = L.attention_decode(blk.attn, h, lc, pos, cfg, binding, **attn_kw)
        elif mode == "chunk":
            y, _ = L.attention_chunk(blk.attn, h, lc, pos, cfg, binding, **attn_kw)
        else:
            y, kv = L.attention_apply(blk.attn, h, cfg, binding, positions=positions)
            if self.kv_quantize:
                # the whole prompt attends over full-precision k/v; the cache
                # it leaves is quantized with every row at the calibration
                sc = torch.full((h.shape[0],), self.kv_scale_init, dtype=torch.float32,
                                device=h.device)
                kv = {"k": L.quant_update(kv["k"], sc, self.kv_dtype),
                      "v": L.quant_update(kv["v"], sc, self.kv_dtype),
                      "k_scale": sc, "v_scale": sc}
            else:
                kv = {name: t.to(self.dtype) for name, t in kv.items()}
        x = x + y
        if hasattr(blk, "moe"):
            x = x + moe_apply(blk.moe, L.norm_apply(blk.post_norm, x, cfg, binding), cfg, binding)
        elif hasattr(blk, "mlp"):
            x = x + L.mlp_apply(blk.mlp, L.norm_apply(blk.post_norm, x, cfg, binding), binding)
        return x, kv

    def _embed(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device).long()
        tok = self.embed["tok"]
        if L.is_quantized(tok):
            # the scales are per d-column (axis -2, the vocab, is reduced
            # away), so dequantizing the gathered rows gives the bits the
            # JAX model's dequantize-the-table-then-gather gives
            return L.dequant_param({"q": tok["q"][tokens], "scale": tok["scale"]}, self.dtype)
        return tok[tokens]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.norm_apply(self.final_norm, x, self.cfg, self.binding)
        if self.cfg.tie_embeddings:
            # the (vocab, d) embedding, transposed; its per-d-column scales do
            # not fit quant_matmul's per-output-channel layout, so a tied head
            # in storage form is dequantized whole, as in JAX
            w = L.dequant_param(self.embed["tok"], x.dtype).t()
        else:
            w = self.lm_head["w"]
        if L.is_quantized(w):
            b, s, d = x.shape
            logits = self.binding["quant_matmul"](x.reshape(b * s, d), w["q"],
                                                  w["scale"]).view(b, s, -1).float()
        else:
            logits = (x @ w).float()
        if self.padded_vocab != self.cfg.vocab_size:
            mask = torch.arange(self.padded_vocab, device=x.device) < self.cfg.vocab_size
            logits = torch.where(mask, logits, -1e9)
        return logits

    def _layer_cache(self, cache: Tree, i: int, rows: slice, paged: bool) -> dict:
        """Block i's cache entries: a paged k/v pool whole, every other leaf
        (contiguous k/v, an SSM's state and conv tail) at `rows`."""
        return {name: buf[i] if paged and name in ("k", "v") else buf[i, rows]
                for name, buf in cache["p0"].items()}

    def _table(self, table) -> torch.Tensor:
        """A host block table as int32 on the device: one copy per tick or
        chunk, shared by every layer."""
        return torch.tensor(np.asarray(table, dtype=np.int32), device=self.device)

    # ------------------------------------------------------------------ #
    # public entry points
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def prefill(self, batch: Mapping[str, Any]):
        """Whole-prompt forward: ``batch["tokens"]`` (B, S) -> (last-token
        logits (B, vocab) float32, the cache it leaves: k/v with S
        positions (quantized, with (B,) scale rows, under `kv_quantize`),
        or an SSM's state and conv tail)."""
        x = self._embed(batch["tokens"])
        positions = torch.arange(x.shape[1], device=self.device)
        leaves: dict[str, list] = {}
        for i in range(self.num_blocks):
            x, kv = self._block(i, x, "prefill", positions=positions)
            for name, t in kv.items():
                leaves.setdefault(name, []).append(t)
        logits = self._logits(x[:, -1:, :].contiguous())[:, 0]
        return logits, {"p0": {name: torch.stack(ts) for name, ts in leaves.items()}}

    @torch.no_grad()
    def prefill_into(self, tokens, cache: Tree, slot: int, pos: int, n_valid: int | None = None,
                     block_row=None, window: int | None = None):
        """Chunked prefill: advance ONE slot of a batched cache by C tokens.

        tokens: (1, C) int — the chunk, right-padded to C; slot: the batch
        row to fill; pos: global position of tokens[:, 0] (the caller keeps
        pos + C <= max_len); n_valid: real tokens in the chunk (default C).
        The cache is updated in place.  Returns (logits (1, vocab) of token
        n_valid-1, cache).  At pos == 0 a slot's leftover SSM state and
        conv tail are not read.

        With `block_row` (this slot's (nblocks,) block-table row, a host
        array) the cache is paged (`init_paged_cache`): each layer's k/v
        pools are passed whole, and the chunk fills page block_row[pos // C];
        an SSM's leaves are the slot's row either way.  With `window` each
        chunk query attends only its trailing `window` keys; pages wholly
        behind the window may already be recycled.
        """
        tokens = torch.as_tensor(tokens, device=self.device)
        if n_valid is None:
            n_valid = tokens.shape[1]
        pos = int(pos)
        x = self._embed(tokens)
        paged = block_row is not None
        attn_kw = {"window": window}
        if paged and "k" in cache["p0"]:
            row = np.asarray(block_row)
            attn_kw["block_tables"] = self._table(row[None])
            attn_kw["write_page"] = int(row[pos // tokens.shape[1]])
        for i in range(self.num_blocks):
            lc = self._layer_cache(cache, i, slice(slot, slot + 1), paged)
            x, _ = self._block(i, x, "chunk", lc=lc, pos=pos, n_valid=n_valid, **attn_kw)
        logits = self._logits(x[:, n_valid - 1:n_valid, :].contiguous())[:, 0]
        return logits, cache

    @torch.no_grad()
    def decode(self, token, cache: Tree, pos, active=None, block_tables=None,
               window: int | None = None):
        """One batched decode tick.  token: (B, 1) int; pos: int, () or (B,)
        int — every row at its own position; active: optional (B,) bool —
        the rows whose SSM state and conv tail may advance (the others keep
        theirs); parked rows' KV writes land at the position the scheduler
        parks (paged: table row all zeros, the write lands in the park
        page).  block_tables: (B, nblocks) int host array — the cache is
        paged.  window: sliding-window decode, only the trailing `window`
        cache slots are attended.  The cache is updated in place.  Returns
        (logits (B, vocab), cache).
        """
        x = self._embed(token)
        b = x.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device).expand(b).contiguous()
        if active is not None and "state" in cache["p0"]:              # only SSM rows read it
            active = torch.as_tensor(np.asarray(active, dtype=bool), device=self.device)
        else:
            active = None
        paged = block_tables is not None
        attn_kw = {"window": window}
        if paged and "k" in cache["p0"]:
            table = self._table(block_tables)
            attn_kw["block_tables"] = table
            attn_kw["write_at"] = L.paged_write_index(pos, table, cache["p0"]["k"].shape[2])
        for i in range(self.num_blocks):
            lc = self._layer_cache(cache, i, slice(None), paged)
            x, _ = self._block(i, x, "decode", lc=lc, pos=pos, active=active, **attn_kw)
        return self._logits(x)[:, 0], cache
