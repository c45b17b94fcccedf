"""The text decoder as an `nn.Module`: dense or mixture-of-experts.

A port of the dense and MoE families of `repro/models/model.py`: the
same schema (embedding, a stack of [pre-norm, attention, post-norm,
SiLU-GLU MLP or MoE] blocks, final norm, LM head), the same cache layout
and the same serving entry points — `prefill`, `prefill_into` (chunked
prefill into one slot of a batched cache) and `decode` (one
continuous-batching tick), each over a contiguous cache (`init_cache`) or
a paged one (`init_paged_cache`: k/v page pools shared by all slots,
addressed through per-slot block tables), with an optional sliding
window — plus `export_paged_slot` / `import_paged_slot`, the KV
handoff's page copy.

The JAX model scans one stacked parameter group over its blocks; here each
block is a module of an `nn.ModuleList` holding its own slice of the stack
(``decoder/p0/attn/wq[i]`` is ``layers.i.attn.wq``).  `Model.schema()` is
the JAX-shaped stacked tree, so shapes compare one to one.

The kernel ops run through `binding` (op name -> callable), which the
caller always passes — a deployed Container's binding; there is no
implicit one.  A MoE block (every block of a config with ``moe_every ==
1``: moonshot, phi3.5-moe) runs `repro_torch.models.moe.moe_apply` after
its post-norm, its grouped matmuls through ``binding["moe_gmm"]``.

Parameters are created on the meta device and bound by `load_params`
(weights from elsewhere, e.g. `repro_torch.convert.params_from_jax`) or
`init` (drawn from a seeded `torch.Generator` on the model's device).

SSM, encoder-decoder, vision, tied-embedding, interleaved-MoE and
quantized paths are not ported: such configurations raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_apply, moe_schema
from repro_torch.models.schema import LeafSpec, init_params, map_leaves, torch_dtype

__all__ = ["Model", "flatten_params", "tree_items"]

Tree = dict[str, Any]


def _stack(tree: Tree, n: int) -> Tree:
    return map_leaves(
        lambda _, s: dataclasses.replace(s, shape=(n,) + s.shape, axes=("layers",) + s.axes),
        tree,
    )


class _Leaves(nn.Module):
    """One parameter subtree: leaves by name, read as ``leaves["wq"]``; a
    nested subtree (the MoE's ``shared`` MLP) is a child `_Leaves`."""

    def __init__(self, specs: Mapping[str, Any], dtype: torch.dtype):
        super().__init__()
        for name, spec in specs.items():
            if isinstance(spec, Mapping):
                self.add_module(name, _Leaves(spec, dtype))
                continue
            t = torch.empty(spec.shape, dtype=torch_dtype(spec.dtype) if spec.dtype else dtype,
                            device="meta")
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class _Block(nn.Module):
    def __init__(self, specs: Tree, dtype: torch.dtype):
        super().__init__()
        for name, sub in specs.items():
            self.add_module(name, _Leaves(sub, dtype))


def flatten_params(tree: Tree) -> dict[str, torch.Tensor]:
    """JAX-layout parameter tree (``decoder/p0/*`` stacked over blocks) ->
    the port's state dict (``layers.{i}.*``), unstacking the block axis.
    The per-layer tensors are views of the stacked ones."""
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
    def __init__(self, cfg: ModelConfig, binding, *, device: str | torch.device = "cuda"):
        super().__init__()
        if (cfg.family not in ("dense", "moe") or cfg.norm != "rmsnorm"
                or cfg.activation != "silu_glu" or cfg.ssm_state or cfg.is_enc_dec
                or cfg.modality != "text" or cfg.tie_embeddings
                or (cfg.num_experts and cfg.moe_every != 1)):
            raise NotImplementedError(
                f"{cfg.name}: only dense or all-MoE, untied, RMSNorm + SiLU-GLU text "
                "decoders are ported")
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
        self.lm_head = _Leaves(self.schema()["lm_head"], self.dtype)

    # ------------------------------------------------------------------ #
    # schema and weights
    # ------------------------------------------------------------------ #
    def _layer_schema(self) -> Tree:
        cfg = self.cfg
        sch: Tree = {
            "pre_norm": L.norm_schema(cfg),
            "attn": L.attention_schema(cfg),
            "post_norm": L.norm_schema(cfg),
        }
        if cfg.is_moe_layer(0):
            sch["moe"] = moe_schema(cfg)
        else:
            sch["mlp"] = L.mlp_schema(cfg)
        return sch

    def schema(self) -> Tree:
        """The JAX model's schema tree (blocks stacked under decoder/p0)."""
        cfg = self.cfg
        return {
            "embed": {"tok": LeafSpec((self.padded_vocab, cfg.d_model), ("vocab", "embed"),
                                      scale=0.01)},
            "decoder": {"p0": _stack(self._layer_schema(), self.num_blocks)},
            "final_norm": L.norm_schema(cfg),
            "lm_head": {"w": LeafSpec((cfg.d_model, self.padded_vocab), ("embed", "vocab"),
                                      init="scaled")},
        }

    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from `generator` (on the model's device)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        return self.load_params(flatten_params(init_params(self.schema(), generator,
                                                           self.cfg.dtype)))

    def load_params(self, state: Mapping[str, torch.Tensor]) -> "Model":
        """Bind a full state dict (``layers.{i}.attn.wq``, ...): each tensor
        is moved to the model's device and dtype, shapes must match."""
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
    def init_cache(self, batch: int, max_len: int) -> Tree:
        """Zeroed KV cache ``{"p0": {"k", "v"}}``, each (layers, B, max_len,
        KV, Dh) in the model dtype — the JAX model's layout."""
        shape = (self.num_blocks, batch, max_len, self.cfg.num_kv_heads, self.cfg.head_dim)
        return {"p0": {name: torch.zeros(shape, dtype=self.dtype, device=self.device)
                       for name in ("k", "v")}}

    def paged_cache_shapes(self, num_pages: int, page_size: int, slots: int) -> Tree:
        """Paged-cache entry shapes, as the JAX model's: attention k/v become
        page pools (layers, num_pages, page_size, KV, Dh) shared by all
        slots.  ``slots`` sizes per-slot state, of which an attention-only
        decoder (dense or MoE) has none."""
        shape = (self.num_blocks, num_pages, page_size, self.cfg.num_kv_heads,
                 self.cfg.head_dim)
        return {"p0": {name: (shape, self.cfg.dtype) for name in ("k", "v")}}

    def init_paged_cache(self, num_pages: int, page_size: int, slots: int) -> Tree:
        """Zeroed paged cache ``{"p0": {"k", "v"}}`` of `paged_cache_shapes`."""
        return {pj: {name: torch.zeros(shape, dtype=torch_dtype(dt), device=self.device)
                     for name, (shape, dt) in entry.items()}
                for pj, entry in self.paged_cache_shapes(num_pages, page_size, slots).items()}

    def export_paged_slot(self, cache: Tree, pages, slot: int) -> dict:
        """One slot's state out of a paged cache, as host numpy arrays.

        ``pages`` is the slot's leased page ids in block-table order (only
        the written prefix).  Keys are ``"p{j}/{leaf}"`` and k/v yield
        ``(layers, len(pages), page_size, KV, Dh)`` page stacks, as the JAX
        model exports them; bf16 pools export as float32 (exact), since
        numpy has no bfloat16.
        """
        ix = torch.as_tensor(np.asarray(pages, dtype=np.int64), device=self.device)
        out: dict = {}
        for pj, entry in cache.items():
            for name, buf in entry.items():
                stack = buf[:, ix]
                if stack.dtype == torch.bfloat16:
                    stack = stack.float()
                out[f"{pj}/{name}"] = stack.cpu().numpy()
        return out

    def import_paged_slot(self, cache: Tree, arrays: Mapping[str, Any], pages,
                          slot: int) -> Tree:
        """Scatter an exported slot into this cache's own ``pages`` (same
        count, any ids), in place; returns the cache.  Every leaf is checked
        before any buffer is written."""
        staged = []
        for pj, entry in cache.items():
            for name, buf in entry.items():
                key = f"{pj}/{name}"
                if key not in arrays:
                    raise ValueError(f"paged-slot import: missing leaf {key}")
                src = np.asarray(arrays[key])
                want = (buf.shape[0], len(pages)) + tuple(buf.shape[2:])
                if src.shape != want:
                    raise ValueError(f"paged-slot import: {key} is {src.shape}, "
                                     f"target pages need {want}")
                if src.dtype.kind not in "fiu":   # e.g. ml_dtypes' bfloat16
                    src = src.astype(np.float32)
                staged.append((buf, src))
        ix = torch.as_tensor(np.asarray(pages, dtype=np.int64), device=self.device)
        for buf, src in staged:
            buf[:, ix] = torch.from_numpy(src).to(device=self.device, dtype=buf.dtype)
        return cache

    # ------------------------------------------------------------------ #
    # forward pieces
    # ------------------------------------------------------------------ #
    def _block(self, i: int, x: torch.Tensor, mode: str, lc=None, pos=None, positions=None,
               **attn_kw):
        blk, cfg, binding = self.layers[i], self.cfg, self.binding
        h = L.norm_apply(blk.pre_norm, x, cfg, binding)
        if mode == "decode":
            y, kv = L.attention_decode(blk.attn, h, lc, pos, cfg, binding, **attn_kw)
        elif mode == "chunk":
            y, kv = L.attention_chunk(blk.attn, h, lc, pos, cfg, binding, **attn_kw)
        else:
            y, kv = L.attention_apply(blk.attn, h, cfg, binding, positions=positions)
        x = x + y
        h = L.norm_apply(blk.post_norm, x, cfg, binding)
        if hasattr(blk, "moe"):
            return x + moe_apply(blk.moe, h, cfg, binding), kv
        return x + L.mlp_apply(blk.mlp, h), kv

    def _embed(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return self.embed["tok"][tokens]

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = L.norm_apply(self.final_norm, x, self.cfg, self.binding)
        logits = (x @ self.lm_head["w"]).float()
        if self.padded_vocab != self.cfg.vocab_size:
            mask = torch.arange(self.padded_vocab, device=x.device) < self.cfg.vocab_size
            logits = torch.where(mask, logits, -1e9)
        return logits

    def _slot_cache(self, cache: Tree, i: int, rows: slice) -> dict:
        return {name: buf[i, rows] for name, buf in cache["p0"].items()}

    def _layer_pools(self, cache: Tree, i: int) -> dict:
        return {name: buf[i] for name, buf in cache["p0"].items()}

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
        logits (B, vocab) float32, cache with S positions)."""
        x = self._embed(batch["tokens"])
        positions = torch.arange(x.shape[1], device=self.device)
        ks, vs = [], []
        for i in range(self.num_blocks):
            x, kv = self._block(i, x, "prefill", positions=positions)
            ks.append(kv["k"].to(self.dtype))
            vs.append(kv["v"].to(self.dtype))
        logits = self._logits(x[:, -1:, :].contiguous())[:, 0]
        return logits, {"p0": {"k": torch.stack(ks), "v": torch.stack(vs)}}

    @torch.no_grad()
    def prefill_into(self, tokens, cache: Tree, slot: int, pos: int, n_valid: int | None = None,
                     block_row=None, window: int | None = None):
        """Chunked prefill: advance ONE slot of a batched cache by C tokens.

        tokens: (1, C) int — the chunk, right-padded to C; slot: the batch
        row to fill; pos: global position of tokens[:, 0] (the caller keeps
        pos + C <= max_len); n_valid: real tokens in the chunk (default C).
        The cache is updated in place.  Returns (logits (1, vocab) of token
        n_valid-1, cache).

        With `block_row` (this slot's (nblocks,) block-table row, a host
        array) the cache is paged (`init_paged_cache`): each layer's pools
        are passed whole, and the chunk fills page block_row[pos // C].
        With `window` each chunk query attends only its trailing `window`
        keys; pages wholly behind the window may already be recycled.
        """
        tokens = torch.as_tensor(tokens, device=self.device)
        if n_valid is None:
            n_valid = tokens.shape[1]
        pos = int(pos)
        x = self._embed(tokens)
        attn_kw = {"window": window}
        if block_row is not None:
            row = np.asarray(block_row)
            attn_kw["block_tables"] = self._table(row[None])
            attn_kw["write_page"] = int(row[pos // tokens.shape[1]])
        for i in range(self.num_blocks):
            lc = (self._layer_pools(cache, i) if block_row is not None
                  else self._slot_cache(cache, i, slice(slot, slot + 1)))
            x, _ = self._block(i, x, "chunk", lc=lc, pos=pos, **attn_kw)
        logits = self._logits(x[:, n_valid - 1:n_valid, :].contiguous())[:, 0]
        return logits, cache

    @torch.no_grad()
    def decode(self, token, cache: Tree, pos, active=None, block_tables=None,
               window: int | None = None):
        """One batched decode tick.  token: (B, 1) int; pos: int, () or (B,)
        int — every row at its own position; active: accepted for the JAX
        signature (it freezes recurrent state, which attention-only
        decoders have none of — parked rows write at the position the scheduler parks;
        paged: table row all zeros, the write lands in the park page).
        block_tables: (B, nblocks) int host array — the cache is paged.
        window: sliding-window decode, only the trailing `window` cache
        slots are attended.  The cache is updated in place.  Returns
        (logits (B, vocab), cache).
        """
        x = self._embed(token)
        b = x.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device).expand(b).contiguous()
        attn_kw = {"window": window}
        if block_tables is not None:
            table = self._table(block_tables)
            attn_kw["block_tables"] = table
            attn_kw["write_at"] = L.paged_write_index(pos, table, cache["p0"]["k"].shape[2])
        for i in range(self.num_blocks):
            lc = (self._layer_pools(cache, i) if block_tables is not None
                  else self._slot_cache(cache, i, slice(None)))
            x, _ = self._block(i, x, "decode", lc=lc, pos=pos, **attn_kw)
        return self._logits(x)[:, 0], cache
