"""The dense text decoder as an `nn.Module`.

A port of the dense family of `repro/models/model.py`: the same schema
(embedding, a stack of [pre-norm, attention, post-norm, SiLU-GLU MLP]
blocks, final norm, LM head), the same cache layout and the same serving
entry points — `prefill`, `prefill_into` (chunked prefill into one slot of
a batched cache) and `decode` (one continuous-batching tick).

The JAX model scans one stacked parameter group over its blocks; here each
block is a module of an `nn.ModuleList` holding its own slice of the stack
(``decoder/p0/attn/wq[i]`` is ``layers.i.attn.wq``).  `Model.schema()` is
the JAX-shaped stacked tree, so shapes compare one to one.

The four kernel ops run through `binding` (op name -> callable), which the
caller always passes — a deployed Container's binding; there is no
implicit one.

Parameters are created on the meta device and bound by `load_params`
(weights from elsewhere, e.g. `repro_torch.convert.params_from_jax`) or
`init` (drawn from a seeded `torch.Generator` on the model's device).

MoE, SSM, encoder-decoder, vision, paged-cache and quantized paths are not
ported: such configurations raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.schema import LeafSpec, init_params, map_leaves, torch_dtype

__all__ = ["Model", "flatten_params", "tree_items"]

Tree = dict[str, Any]


def _stack(tree: Tree, n: int) -> Tree:
    return map_leaves(
        lambda _, s: dataclasses.replace(s, shape=(n,) + s.shape, axes=("layers",) + s.axes),
        tree,
    )


class _Leaves(nn.Module):
    """One parameter subtree: leaves by name, read as ``leaves["wq"]``."""

    def __init__(self, specs: Mapping[str, LeafSpec], dtype: torch.dtype):
        super().__init__()
        for name, spec in specs.items():
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
                raise ValueError(f"dense decoders have one pattern position, got {path}")
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
        if (cfg.family != "dense" or cfg.norm != "rmsnorm" or cfg.activation != "silu_glu"
                or cfg.num_experts or cfg.ssm_state or cfg.is_enc_dec
                or cfg.modality != "text" or cfg.tie_embeddings):
            raise NotImplementedError(
                f"{cfg.name}: only dense, untied, RMSNorm + SiLU-GLU text decoders are ported")
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
        return {
            "pre_norm": L.norm_schema(cfg),
            "attn": L.attention_schema(cfg),
            "post_norm": L.norm_schema(cfg),
            "mlp": L.mlp_schema(cfg),
        }

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

    # ------------------------------------------------------------------ #
    # forward pieces
    # ------------------------------------------------------------------ #
    def _block(self, i: int, x: torch.Tensor, mode: str, lc=None, pos=None, positions=None):
        blk, cfg, binding = self.layers[i], self.cfg, self.binding
        h = L.norm_apply(blk.pre_norm, x, cfg, binding)
        if mode == "decode":
            y, kv = L.attention_decode(blk.attn, h, lc, pos, cfg, binding)
        elif mode == "chunk":
            y, kv = L.attention_chunk(blk.attn, h, lc, pos, cfg, binding)
        else:
            y, kv = L.attention_apply(blk.attn, h, cfg, binding, positions=positions)
        x = x + y
        h = L.norm_apply(blk.post_norm, x, cfg, binding)
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
    def prefill_into(self, tokens, cache: Tree, slot: int, pos: int, n_valid: int | None = None):
        """Chunked prefill: advance ONE slot of a batched cache by C tokens.

        tokens: (1, C) int — the chunk, right-padded to C; slot: the batch
        row to fill; pos: global position of tokens[:, 0] (the caller keeps
        pos + C <= max_len); n_valid: real tokens in the chunk (default C).
        The cache is updated in place.  Returns (logits (1, vocab) of token
        n_valid-1, cache).
        """
        tokens = torch.as_tensor(tokens, device=self.device)
        if n_valid is None:
            n_valid = tokens.shape[1]
        x = self._embed(tokens)
        rows = slice(slot, slot + 1)
        for i in range(self.num_blocks):
            x, _ = self._block(i, x, "chunk", lc=self._slot_cache(cache, i, rows), pos=int(pos))
        logits = self._logits(x[:, n_valid - 1:n_valid, :].contiguous())[:, 0]
        return logits, cache

    @torch.no_grad()
    def decode(self, token, cache: Tree, pos, active=None):
        """One batched decode tick.  token: (B, 1) int; pos: int, () or (B,)
        int — every row at its own position; active: accepted for the JAX
        signature (it freezes recurrent state, which dense decoders have
        none of — parked rows write at the position the scheduler parks).
        The cache is updated in place.  Returns (logits (B, vocab), cache).
        """
        x = self._embed(token)
        b = x.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device).expand(b).contiguous()
        for i in range(self.num_blocks):
            x, _ = self._block(i, x, "decode", lc=self._slot_cache(cache, i, slice(None)),
                               pos=pos)
        return self._logits(x)[:, 0], cache
