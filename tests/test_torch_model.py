"""The port's dense decoder held against the JAX model, on the CPU.

The reduced qwen2.5-14b with the JAX model's own weights (`Model.init`,
moved across by `params_from_jax`) must give the JAX fp32 logits within
atol = rtol = 1e-4 for whole-prompt `prefill`, chunked `prefill_into`
with a partial last chunk, and `decode` at per-slot positions with a
parked slot — through the reference binding on both sides, and through
the kernel path on both sides (the JAX Pallas kernels in interpret mode;
the port's CUDA wrappers, which on CPU tensors take their plain
versions).  The KV caches the steps leave behind must agree as well.
The same holds over a paged cache (shuffled block tables, a parked slot
on the park page), with a sliding window, and with both; a paged slot
exported by either model imports into the other.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.platform import POD_SIM
from repro.kernels.ops import register_all as jax_register_all
from repro.models.model import Model as JaxModel
from repro.models.schema import leaf_items as jax_leaf_items
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.runtime import Runtime
from repro_torch.kernels.ops import PORTED_OPS
from repro_torch.kernels.ops import _NATIVES as TORCH_NATIVES
from repro_torch.launch.bundle import make_bundle
from repro_torch.models.model import Model
from repro_torch.models.schema import leaf_items

ARCH = "qwen2.5-14b"
TOL = 1e-4
SLOTS, MAX_LEN, CHUNK = 3, 32, 5


def _seed(*parts) -> int:
    return zlib.crc32(":".join(map(str, parts)).encode()) & 0x7FFFFFFF


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_get_config(ARCH).reduced()
    return JaxModel(cfg).init(jax.random.PRNGKey(0))


def _jax_binding(kernels: bool):
    if not kernels:
        return None   # the JAX model's default: references
    from repro.core.registry import OpRegistry as JaxRegistry

    reg = jax_register_all(JaxRegistry())
    return reg.bind(reg.declared(), POD_SIM, native=True, freeze=False)


def _torch_binding(kernels: bool):
    if not kernels:
        # what a CPU deployment binds: every op on its reference
        rt = Runtime(host_env={})
        binding = rt.deploy(make_bundle(ARCH, reduced=True), device="cpu").binding
        rt.cleanup()
        return binding
    return {op: TORCH_NATIVES[op] for op in PORTED_OPS}


def _pair(jax_params, kernels):
    cfg = get_config(ARCH).reduced()
    jm = JaxModel(jax_get_config(ARCH).reduced(), binding=_jax_binding(kernels))
    tm = Model(cfg, _torch_binding(kernels), device="cpu").load_params(
        params_from_jax(jax.tree.map(np.asarray, jax_params), cfg))
    return jm, tm


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def _close_cache(tcache, jcache):
    for name in ("k", "v"):
        _close(tcache["p0"][name], jcache["p0"][name])


def test_schema_equals_jax():
    cfg = get_config(ARCH).reduced()
    ours = {p: (s.shape, s.axes, s.init, s.scale) for p, s in
            leaf_items(Model(cfg, {}, device="meta").schema())}
    theirs = {p: (s.shape, s.axes, s.init, s.scale) for p, s in
              jax_leaf_items(JaxModel(jax_get_config(ARCH).reduced()).schema())}
    assert ours == theirs


def test_full_width_schema_holds_14_7b_parameters():
    model = Model(get_config(ARCH), {}, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert 14.7e9 < n < 14.8e9
    assert len(model.layers) == 48


def test_seeded_init_is_reproducible_and_follows_the_rules():
    cfg = get_config(ARCH).reduced()
    a = Model(cfg, {}, device="cpu").init(torch.Generator().manual_seed(3))
    b = Model(cfg, {}, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert torch.equal(a.layers[0].attn.bq, torch.zeros_like(a.layers[0].attn.bq))
    assert torch.equal(a.final_norm.scale, torch.ones_like(a.final_norm.scale))
    # "scaled" leaves of the stack use the stacked fan-in (the layer count),
    # exactly as the JAX schema does
    std = a.layers[0].mlp.w_in.std().item()
    assert abs(std - cfg.num_layers ** -0.5) < 0.1 * cfg.num_layers ** -0.5


@pytest.mark.parametrize("kernels", [False, True], ids=["refs", "kernels"])
def test_prefill_matches_jax(jax_params, kernels):
    jm, tm = _pair(jax_params, kernels)
    tokens = np.random.default_rng(_seed("prefill", kernels)).integers(0, 256, (2, 11))
    jl, jc = jax.jit(jm.prefill)(jax_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tokens)})
    assert tl.shape == (2, 256) and tl.dtype == torch.float32
    _close(tl, jl)
    _close_cache(tc, jc)


@pytest.mark.parametrize("kernels", [False, True], ids=["refs", "kernels"])
def test_prefill_into_partial_last_chunk_matches_jax(jax_params, kernels):
    jm, tm = _pair(jax_params, kernels)
    prompt = np.random.default_rng(_seed("prefill_into", kernels)).integers(0, 256, 13)
    jcache, tcache = jm.init_cache(SLOTS, MAX_LEN), tm.init_cache(SLOTS, MAX_LEN)
    step = jax.jit(jm.prefill_into)
    slot = 1
    for start in range(0, len(prompt), CHUNK):         # 5 + 5 + 3
        n = min(CHUNK, len(prompt) - start)
        buf = np.zeros((1, CHUNK), np.int32)
        buf[0, :n] = prompt[start:start + n]
        jl, jcache = step(jax_params, jnp.asarray(buf), jcache, jnp.int32(slot),
                          jnp.int32(start), jnp.int32(n))
        tl, tcache = tm.prefill_into(torch.from_numpy(buf), tcache, slot, start, n)
        _close(tl, jl)
    _close_cache(tcache, jcache)


@pytest.mark.parametrize("kernels", [False, True], ids=["refs", "kernels"])
def test_decode_per_slot_positions_with_parked_slot_matches_jax(jax_params, kernels):
    jm, tm = _pair(jax_params, kernels)
    rng = np.random.default_rng(_seed("decode", kernels))
    # a cache holding earlier writes (random values), shared by both sides
    shape = (2, SLOTS, MAX_LEN, 2, 16)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jcache = {"p0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}
    tcache = {"p0": {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}}
    pos = np.array([4, 17, MAX_LEN - 1], np.int32)      # slot 2 parked at max_len-1
    active = np.array([True, True, False])
    decode = jax.jit(jm.decode)
    for _ in range(2):
        token = rng.integers(0, 256, (SLOTS, 1)).astype(np.int32)
        jl, jcache = decode(jax_params, jnp.asarray(token), jcache, jnp.asarray(pos),
                            jnp.asarray(active))
        tl, tcache = tm.decode(torch.from_numpy(token), tcache, torch.from_numpy(pos), active)
        _close(tl, jl)
        pos = pos + active
    _close_cache(tcache, jcache)


PAGE = CHUNK          # the serving invariant: one prefill chunk fills one page
WINDOW = 6


def _paged_tables(rng, num_pages):
    """Shuffled tables for slots 0 and 1; slot 2 parked (all zeros)."""
    nblocks = -(-MAX_LEN // PAGE)
    ids = rng.permutation(np.arange(1, num_pages))[:2 * nblocks].reshape(2, nblocks)
    return np.concatenate([ids, np.zeros((1, nblocks), np.int64)]).astype(np.int32)


@pytest.mark.parametrize("kernels", [False, True], ids=["refs", "kernels"])
@pytest.mark.parametrize("mode", ["paged", "windowed", "paged-windowed"])
def test_paged_and_windowed_steps_match_jax(jax_params, mode, kernels):
    """prefill_into (full and partial last chunk) into slot 1, then decode
    ticks with slot 2 parked, over the mode's cache: logits and caches
    equal to the JAX model's within 1e-4."""
    jm, tm = _pair(jax_params, kernels)
    rng = np.random.default_rng(_seed("paged-steps", mode, kernels))
    paged = mode.startswith("paged")
    window = WINDOW if mode.endswith("windowed") else None
    if paged:
        num_pages = 1 + SLOTS * -(-MAX_LEN // PAGE)
        shape = (2, num_pages, PAGE, 2, 16)
        tables = _paged_tables(rng, num_pages)
    else:
        shape, tables = (2, SLOTS, MAX_LEN, 2, 16), None
    # a cache holding earlier writes (random values), shared by both sides
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jcache = {"p0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}
    tcache = {"p0": {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}}
    jwin = None if window is None else jnp.int32(window)

    prompt = rng.integers(0, 256, 13)
    step = jax.jit(jm.prefill_into)
    slot = 1
    for start in range(0, len(prompt), CHUNK):         # 5 + 5 + 3
        n = min(CHUNK, len(prompt) - start)
        buf = np.zeros((1, CHUNK), np.int32)
        buf[0, :n] = prompt[start:start + n]
        kw = {} if tables is None else {"block_row": jnp.asarray(tables[slot])}
        jl, jcache = step(jax_params, jnp.asarray(buf), jcache, jnp.int32(slot),
                          jnp.int32(start), jnp.int32(n), window=jwin, **kw)
        tl, tcache = tm.prefill_into(torch.from_numpy(buf), tcache, slot, start, n,
                                     block_row=None if tables is None else tables[slot],
                                     window=window)
        _close(tl, jl)

    pos = np.array([9, len(prompt), MAX_LEN - 1], np.int32)   # slot 2 parked
    active = np.array([True, True, False])
    decode = jax.jit(jm.decode)
    for _ in range(2):
        token = rng.integers(0, 256, (SLOTS, 1)).astype(np.int32)
        jl, jcache = decode(jax_params, jnp.asarray(token), jcache, jnp.asarray(pos),
                            jnp.asarray(active),
                            None if tables is None else jnp.asarray(tables), jwin)
        tl, tcache = tm.decode(torch.from_numpy(token), tcache, torch.from_numpy(pos), active,
                               block_tables=tables, window=window)
        _close(tl[:2], jl[:2])                 # the parked row's logits are garbage
        pos = pos + active
    if paged:
        # every page but the park page, which parked rows scribble on
        for name in ("k", "v"):
            _close(tcache["p0"][name][:, 1:], jcache["p0"][name][:, 1:])
    else:
        _close_cache(tcache, jcache)


def test_paged_cache_layout_equals_jax():
    cfg = get_config(ARCH).reduced()
    tm = Model(cfg, {}, device="cpu")
    jm = JaxModel(jax_get_config(ARCH).reduced())
    ours = tm.paged_cache_shapes(9, 4, 2)
    theirs = jm.paged_cache_shapes(9, 4, 2)
    assert {pj: {n: (tuple(s), str(d)) for n, (s, d) in e.items()} for pj, e in ours.items()} \
        == {pj: {n: (tuple(s), str(d)) for n, (s, d) in e.items()} for pj, e in theirs.items()}
    cache = tm.init_paged_cache(9, 4, 2)
    assert cache["p0"]["k"].shape == (2, 9, 4, 2, 16) and not cache["p0"]["v"].any()


def test_paged_slot_export_and_import_cross_frameworks():
    """Both models export the same "p0/k"/"p0/v" page stacks, and each
    imports the other's into pages of its own numbering."""
    cfg = get_config(ARCH).reduced()
    tm = Model(cfg, {}, device="cpu")
    jm = JaxModel(jax_get_config(ARCH).reduced())
    rng = np.random.default_rng(_seed("export"))
    k, v = (rng.standard_normal((2, 9, 4, 2, 16)).astype(np.float32) for _ in range(2))
    jcache = {"p0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}
    tcache = {"p0": {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}}
    pages = [7, 2, 5]
    theirs = jm.export_paged_slot(jcache, pages, 1)
    ours = tm.export_paged_slot(tcache, pages, 1)
    assert set(ours) == set(theirs) == {"p0/k", "p0/v"}
    for key in ours:
        np.testing.assert_array_equal(ours[key], np.asarray(theirs[key]))
    target = [1, 3, 8]
    tm.import_paged_slot(tcache, theirs, target, 0)
    jcache = jm.import_paged_slot(jcache, ours, target, 0)
    for name in ("k", "v"):
        np.testing.assert_array_equal(tcache["p0"][name].numpy(), np.asarray(jcache["p0"][name]))
        np.testing.assert_array_equal(tcache["p0"][name][:, target].numpy(),
                                      ours[f"p0/{name}"])
    with pytest.raises(ValueError, match="target pages"):
        tm.import_paged_slot(tcache, ours, [1, 3], 0)


def test_params_from_jax_rejects_a_mismatched_tree(jax_params):
    cfg = get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jax_params)
    tree["lm_head"]["w"] = tree["lm_head"]["w"][:, :8]
    with pytest.raises(ValueError, match="lm_head/w"):
        params_from_jax(tree, cfg)
    del tree["lm_head"]
    with pytest.raises(KeyError):
        params_from_jax(tree, cfg)


def test_model_needs_a_binding():
    # no implicit reference binding: a model on the card runs what its
    # deployment bound
    with pytest.raises(TypeError):
        Model(get_config(ARCH).reduced(), device="meta")


def test_unported_families_raise():
    cfg = get_config(ARCH).reduced()
    for change in ({"family": "hybrid", "ssm_state": 16, "attn_every": 2},
                   {"encoder_layers": 2, "family": "audio"}, {"modality": "vision"},
                   {"norm": "layernorm"}):
        with pytest.raises(NotImplementedError):
            Model(dataclasses.replace(cfg, **change), {}, device="meta")
