"""The port's MoE slice held against the JAX package, on the CPU.

  * the config copies (moonshot-v1-16b-a3b, phi3.5-moe-42b-a6.6b) equal
    their originals;
  * the grouped matmul: `moe_gmm_exact` and `moe_gmm_ref` against the JAX
    references (fp32 1e-6, bf16 2e-2), at <= 1024 rows and above, with
    skewed groups so the capacity path drops rows; the CUDA wrapper's CPU
    path against the JAX Pallas kernel in interpret mode (as
    tests/test_kernels.py runs it), empty groups included, within TOLS;
  * the layer: `moe_apply` against the JAX one, with and without shared
    experts, through references and kernels, and against the dense oracle;
  * the model: reduced moonshot and phi3.5-moe `prefill`, `prefill_into`
    (partial last chunk) and `decode` (a parked slot) against the JAX fp32
    logits at 1e-4, over a contiguous and a paged cache; the
    prefill/decode consistency case of tests/test_models_consistency.py
    (5e-4); `params_from_jax` carries the ``moe`` subtree;
  * serving: `TorchEngine` greedy tokens identical to `JaxEngine`'s on the
    reduced moonshot, contiguous and paged; a deployment lists `moe_gmm`
    as ported, its native provider `cuda`.

Inputs are drawn with numpy from a crc32 seed of the case and handed to
both frameworks; bf16 inputs are the same fp32 draws rounded once.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import Runtime as JaxRuntime
from repro.core.platform import POD_SIM
from repro.kernels.moe_gmm import moe_gmm as jax_moe_gmm
from repro.kernels.moe_gmm_ref import moe_gmm_exact as jax_moe_gmm_exact
from repro.kernels.moe_gmm_ref import moe_gmm_ref as jax_moe_gmm_ref
from repro.kernels.ops import _NATIVES_INTERPRET
from repro.kernels.ops import register_all as jax_register_all
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import Server as JaxServer
from repro.launch.train import make_bundle as jax_make_bundle
from repro.models.layers import ParallelCtx
from repro.models.model import Model as JaxModel
from repro.models.moe import moe_apply as jax_moe_apply
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.platform import CUDA_KERNELS
from repro_torch.core.runtime import Runtime
from repro_torch.kernels import _build
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.moe_gmm_ref import _EXACT_ROWS_MAX, moe_gmm_exact, moe_gmm_ref
from repro_torch.kernels.ops import PORTED_OPS
from repro_torch.kernels.ops import _NATIVES as TORCH_NATIVES
from repro_torch.kernels.ops import register_all
from repro_torch.launch.bundle import make_bundle
from repro_torch.launch.serve import Request, Server
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.layers import mlp_apply
from repro_torch.models.model import Model
from repro_torch.models.moe import _dense_oracle, _route, moe_apply

MOONSHOT, PHI = "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"
ARCHS = (MOONSHOT, PHI)
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}      # the kernel grids' tolerances
REF_TOLS = {"float32": 1e-6, "bfloat16": 2e-2}  # reference against reference
MODEL_TOL = 1e-4
SLOTS, MAX_LEN, CHUNK = 3, 32, 5


def _seed(*parts) -> int:
    return zlib.crc32(":".join(map(str, parts)).encode()) & 0x7FFFFFFF


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    return jnp.asarray(a, jnp.dtype(dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# config copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_config_copies_equal_originals(arch, reduced):
    ours, theirs = get_config(arch), jax_get_config(arch)
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert ours.to_dict() == theirs.to_dict()
    assert ours.param_count() == theirs.param_count()
    assert make_bundle(arch, reduced=reduced).digest == \
        jax_make_bundle(arch, reduced=reduced).digest


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------

def _gmm_inputs(seed, sizes, d, f, dtype):
    rng = np.random.default_rng(seed)
    t, e = int(sum(sizes)), len(sizes)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)
    return (jx, jw, jnp.asarray(gs)), (tx, tw, torch.from_numpy(gs))


# (group sizes, D, F): decode-like (mostly one row, empty experts), small
# groups, one expert holding every row, and > _EXACT_ROWS_MAX rows with a
# skewed split whose largest group overflows the capacity (1.25 T / E)
GMM_CASES = {
    "decode": ([1, 0, 2, 1, 0, 1, 1, 0], 16, 24),
    "small": ([5, 0, 9, 2], 32, 16),
    "one-expert": ([0, 13, 0], 16, 8),
    "skewed-1100": ([700, 300, 100, 0], 16, 24),
}


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_moe_gmm_references_match_jax(case, dtype):
    sizes, d, f = GMM_CASES[case]
    (jx, jw, jgs), (tx, tw, tgs) = _gmm_inputs(_seed("gmm-ref", case, dtype), sizes, d, f, dtype)
    tol = REF_TOLS[dtype]
    _close(moe_gmm_exact(tx, tw, tgs), jax_moe_gmm_exact(jx, jw, jgs), tol)
    ref = moe_gmm_ref(tx, tw, tgs)
    assert ref.dtype == tx.dtype and ref.shape == (sum(sizes), f)
    _close(ref, jax_moe_gmm_ref(jx, jw, jgs), tol)
    # an explicit capacity factor runs the capacity formulation at any size
    _close(moe_gmm_ref(tx, tw, tgs, capacity_factor=1.0),
           jax_moe_gmm_ref(jx, jw, jgs, capacity_factor=1.0), tol)
    if sum(sizes) > _EXACT_ROWS_MAX:
        # the capacity path really dropped rows (cap = 344 of group 0's 700)
        dropped = int((ref.float().abs().sum(1) == 0).sum())
        assert dropped == 700 - 344


GMM_KERNEL_CASES = [(16, 8, 2, 8), (24, 16, 3, 24), (8, 8, 8, 16)]   # t, d, e, f


@pytest.mark.parametrize("dtype", list(TOLS))
@pytest.mark.parametrize("geom", GMM_KERNEL_CASES, ids=lambda g: "x".join(map(str, g)))
def test_moe_gmm_wrapper_matches_pallas_interpret(geom, dtype):
    """The wrapper's CPU path (dropless) against the Pallas kernel run as
    tests/test_kernels.py runs it; the split has empty groups."""
    t, d, e, f = geom
    rng = np.random.default_rng(_seed("gmm-kernel", *geom, dtype))
    splits = np.sort(rng.integers(0, t + 1, e - 1))
    sizes = np.diff(np.concatenate([[0], splits, [t]])).astype(np.int32)
    sizes[rng.integers(0, e - 1)] = 0                   # at least one empty group
    sizes[-1] += t - sizes.sum()
    (jx, jw, jgs), (tx, tw, tgs) = _gmm_inputs(_seed("gmm-kernel-in", *geom, dtype), sizes,
                                               d, f, dtype)
    want = jax_moe_gmm(jx, jw, jgs, block_m=8, block_n=8, interpret=True)
    before = dict(_build.LAUNCHES)
    got = moe_gmm(tx, tw, tgs)
    assert got.dtype == tx.dtype and got.shape == (t, f)
    _close(got, want, TOLS[dtype])
    assert dict(_build.LAUNCHES) == before and _build._lib is None   # CPU: plain version


def test_moe_gmm_exact_edges():
    """Rows past sum(group_sizes) are 0 and a group past T is cut at T:
    what the kernel does with such sizes."""
    x = torch.ones(6, 4)
    w = torch.ones(3, 4, 4)
    out = moe_gmm_exact(x, w, torch.tensor([2, 0, 1], dtype=torch.int32))
    assert out[:3].eq(4).all() and out[3:].eq(0).all()
    out = moe_gmm_exact(x, w, torch.tensor([4, 9, 0], dtype=torch.int32))
    assert out.eq(4).all()


@pytest.mark.parametrize("t, f", [(0, 32), (8, 0)])
def test_moe_gmm_counts_no_launch_when_there_is_nothing_to_compute(t, f, monkeypatch):
    """Off the CPU an empty output launches nothing, so it neither builds
    the library nor counts a launch.  (Meta tensors stand in for the card's:
    they take the same branch and hold no data.)"""
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "library", no_build)
    x = torch.empty(t, 64, device="meta")
    w = torch.empty(4, 64, f, device="meta")
    gs = torch.zeros(4, dtype=torch.int32, device="meta")
    before = dict(_build.LAUNCHES)
    assert moe_gmm(x, w, gs).shape == (t, f)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("bad", ["gs-dtype", "gs-length", "w-dtype", "contraction", "layout",
                                 "rank"])
def test_moe_gmm_wrapper_checks_on_every_device(bad):
    x, w = torch.zeros(4, 8), torch.zeros(2, 8, 8)
    gs = torch.tensor([3, 1], dtype=torch.int32)
    if bad == "gs-dtype":
        gs = gs.long()
    elif bad == "gs-length":
        gs = torch.tensor([4], dtype=torch.int32)
    elif bad == "w-dtype":
        w = w.bfloat16()
    elif bad == "contraction":
        w = torch.zeros(2, 4, 8)
    elif bad == "layout":
        w = torch.zeros(2, 8, 16)[:, :, ::2]
    else:
        x = x[None]
    with pytest.raises(ValueError):
        moe_gmm(x, w, gs)


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _layer_params(cfg, seed):
    """Numpy draws of one MoE layer's leaves (the shared MLP's nested)."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.expert_d_ff

    def draw(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    params = {"router": draw(d, e), "w_in": draw(e, d, f), "w_gate": draw(e, d, f),
              "w_out": draw(e, f, d)}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        params["shared"] = {"w_in": draw(d, fs), "w_out": draw(fs, d), "w_gate": draw(d, fs)}
    return params


def _tree(params, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in params.items()}


@pytest.mark.parametrize("path", ["refs", "kernels", "oracle"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, path):
    cfg = get_config(arch).reduced()
    jcfg = jax_get_config(arch).reduced()
    assert bool(cfg.n_shared_experts) == (arch == MOONSHOT)
    params = _layer_params(cfg, _seed("moe-params", arch))
    x = np.random.default_rng(_seed("moe-x", arch, path)).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    jbind = {"moe_gmm": _NATIVES_INTERPRET["moe_gmm"] if path == "kernels" else jax_moe_gmm_ref}
    tbind = {"moe_gmm": moe_gmm if path == "kernels" else moe_gmm_ref}
    oracle = path == "oracle"
    want, _ = jax_moe_apply(_tree(params, jnp.asarray), jnp.asarray(x), jcfg, ParallelCtx(),
                            jbind, oracle=oracle)
    tparams = _tree(params, torch.from_numpy)
    apply = _oracle_apply if oracle else moe_apply
    got = apply(tparams, torch.from_numpy(x), cfg, tbind)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want, MODEL_TOL)
    if not oracle:
        # the sorted grouped-matmul path against every-expert-on-every-token
        _close(got, _oracle_apply(tparams, torch.from_numpy(x), cfg, tbind), MODEL_TOL)


def _oracle_apply(params, x, cfg, binding=None):
    """The MoE layer with the dense oracle in place of the grouped matmuls:
    the same routing, every expert on every token, plus the shared MLP."""
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    y = _dense_oracle(x_flat, *_route(x_flat, params["router"], cfg.top_k), params, cfg)
    if cfg.n_shared_experts:
        y = y + mlp_apply(params["shared"], x).reshape(b * s, d).to(y.dtype)
    return y.reshape(b, s, d).to(x.dtype)


def test_moe_apply_runs_three_grouped_matmuls_on_the_layer_rows():
    cfg = get_config(MOONSHOT).reduced()
    params = _tree(_layer_params(cfg, _seed("moe-count")), torch.from_numpy)
    calls = []

    def spy(x, w, gs):
        calls.append((tuple(x.shape), tuple(w.shape), int(gs.sum())))
        return moe_gmm_ref(x, w, gs)

    moe_apply(params, torch.zeros(2, 5, cfg.d_model), cfg, {"moe_gmm": spy})
    rows, d, e, f = 2 * 5 * cfg.top_k, cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    assert calls == [((rows, d), (e, d, f), rows), ((rows, d), (e, d, f), rows),
                     ((rows, f), (e, f, d), rows)]


def test_moe_apply_reads_nothing_back_to_the_host(monkeypatch):
    """The layer around the op hands the device's tensors on as they are:
    no .item()/.tolist()/.cpu()/.numpy() of the routing or the group sizes
    (on the card each would stall the host; chip_smoke.py checks the same
    there with the sync debug mode)."""
    cfg = get_config(MOONSHOT).reduced()
    params = _tree(_layer_params(cfg, _seed("moe-host")), torch.from_numpy)
    x = torch.from_numpy(np.random.default_rng(_seed("moe-host-x")).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32))

    def fake_gmm(x, w, gs):     # the kernel's contract without reading gs
        return torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype)

    def refuse(*a, **k):
        raise AssertionError("moe_apply read a tensor back to the host")

    for name in ("item", "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    y = moe_apply(params, x, cfg, {"moe_gmm": fake_gmm})
    assert y.shape == x.shape


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = JaxModel(jax_get_config(arch).reduced()).init(jax.random.PRNGKey(0))
        return cache[arch]
    return get


def _pair(arch, jparams, kernels):
    cfg = get_config(arch).reduced()
    if kernels:
        from repro.core.registry import OpRegistry as JaxRegistry

        reg = jax_register_all(JaxRegistry())
        jbinding = reg.bind(reg.declared(), POD_SIM, native=True, freeze=False)
        tbinding = {op: TORCH_NATIVES[op] for op in PORTED_OPS}
    else:
        jbinding = None   # the JAX model's default: references
        rt = Runtime(host_env={})
        tbinding = rt.deploy(make_bundle(arch, reduced=True), device="cpu").binding
        rt.cleanup()
    jm = JaxModel(jax_get_config(arch).reduced(), binding=jbinding)
    tm = Model(cfg, tbinding, device="cpu").load_params(
        params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jm, tm


def test_params_from_jax_carries_the_moe_subtree(jax_params):
    cfg = get_config(MOONSHOT).reduced()
    tree = jax.tree.map(np.asarray, jax_params(MOONSHOT))
    state = params_from_jax(tree, cfg)
    moe = tree["decoder"]["p0"]["moe"]
    for i in range(cfg.num_layers):
        for name in ("router", "w_in", "w_gate", "w_out"):
            np.testing.assert_array_equal(state[f"layers.{i}.moe.{name}"].numpy(),
                                          moe[name][i])
        for name in ("w_in", "w_gate", "w_out"):
            np.testing.assert_array_equal(state[f"layers.{i}.moe.shared.{name}"].numpy(),
                                          moe["shared"][name][i])
    assert state["layers.0.moe.router"].dtype == torch.float32
    tm = Model(dataclasses.replace(cfg, dtype="bfloat16"), {}, device="cpu").load_params(state)
    # the router stays fp32 in a bf16 model, as its schema says
    assert tm.layers[1].moe.router.dtype == torch.float32
    assert tm.layers[1].moe.shared.w_in.dtype == torch.bfloat16


@pytest.mark.parametrize("kernels", [False, True], ids=["refs", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_prefill_matches_jax(jax_params, arch, kernels):
    jp = jax_params(arch)
    jm, tm = _pair(arch, jp, kernels)
    tokens = np.random.default_rng(_seed("prefill", arch, kernels)).integers(0, 256, (2, 11))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens, jnp.int32)})
    tl, tc = tm.prefill({"tokens": torch.from_numpy(tokens)})
    _close(tl, jl, MODEL_TOL)
    for name in ("k", "v"):
        _close(tc["p0"][name], jc["p0"][name], MODEL_TOL)


PAGE = CHUNK          # the serving invariant: one prefill chunk fills one page


@pytest.mark.parametrize("kernels", [False, True], ids=["refs", "kernels"])
@pytest.mark.parametrize("mode", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_steps_match_jax(jax_params, arch, mode, kernels):
    """prefill_into (5 + 5 + 3, a partial last chunk) into slot 1, then two
    decode ticks with slot 2 parked: logits and caches equal to the JAX
    model's within 1e-4."""
    jp = jax_params(arch)
    jm, tm = _pair(arch, jp, kernels)
    cfg = tm.cfg
    rng = np.random.default_rng(_seed("steps", arch, mode, kernels))
    kvh, dh = cfg.num_kv_heads, cfg.head_dim
    if mode == "paged":
        nblocks = -(-MAX_LEN // PAGE)
        num_pages = 1 + SLOTS * nblocks
        shape = (cfg.num_layers, num_pages, PAGE, kvh, dh)
        ids = rng.permutation(np.arange(1, num_pages))[:2 * nblocks].reshape(2, nblocks)
        tables = np.concatenate([ids, np.zeros((1, nblocks), np.int64)]).astype(np.int32)
    else:
        shape, tables = (cfg.num_layers, SLOTS, MAX_LEN, kvh, dh), None
    # a cache holding earlier writes (random values), shared by both sides
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jcache = {"p0": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}
    tcache = {"p0": {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}}

    prompt = rng.integers(0, 256, 13)
    step = jax.jit(jm.prefill_into)
    slot = 1
    for start in range(0, len(prompt), CHUNK):         # 5 + 5 + 3
        n = min(CHUNK, len(prompt) - start)
        buf = np.zeros((1, CHUNK), np.int32)
        buf[0, :n] = prompt[start:start + n]
        kw = {} if tables is None else {"block_row": jnp.asarray(tables[slot])}
        jl, jcache = step(jp, jnp.asarray(buf), jcache, jnp.int32(slot), jnp.int32(start),
                          jnp.int32(n), **kw)
        tl, tcache = tm.prefill_into(torch.from_numpy(buf), tcache, slot, start, n,
                                     block_row=None if tables is None else tables[slot])
        _close(tl, jl, MODEL_TOL)

    pos = np.array([9, len(prompt), MAX_LEN - 1], np.int32)   # slot 2 parked
    active = np.array([True, True, False])
    decode = jax.jit(jm.decode)
    for _ in range(2):
        token = rng.integers(0, 256, (SLOTS, 1)).astype(np.int32)
        jl, jcache = decode(jp, jnp.asarray(token), jcache, jnp.asarray(pos),
                            jnp.asarray(active), None if tables is None else jnp.asarray(tables))
        tl, tcache = tm.decode(torch.from_numpy(token), tcache, torch.from_numpy(pos), active,
                               block_tables=tables)
        _close(tl[:2], jl[:2], MODEL_TOL)      # the parked row's logits are garbage
        pos = pos + active
    # every page but the park page, which parked rows scribble on; the
    # contiguous cache whole but the parked row's slot
    for name in ("k", "v"):
        if tables is None:
            _close(tcache["p0"][name][:, :2], jcache["p0"][name][:, :2], MODEL_TOL)
        else:
            _close(tcache["p0"][name][:, 1:], jcache["p0"][name][:, 1:], MODEL_TOL)


@pytest.mark.parametrize("kernels", [False, True], ids=["refs", "kernels"])
def test_moonshot_prefill_decode_consistency(jax_params, kernels):
    """tests/test_models_consistency.py's case on the port: the last
    token's logits from a whole prefill equal those of a prefill of the
    rest followed by one decode step (5e-4)."""
    _, tm = _pair(MOONSHOT, jax_params(MOONSHOT), kernels)
    b, s = 2, 16
    toks = torch.from_numpy(np.random.default_rng(_seed("consistency", kernels)).integers(
        0, tm.cfg.vocab_size, (b, s)))
    full, _ = tm.prefill({"tokens": toks})
    _, cache = tm.prefill({"tokens": toks[:, :-1]})
    cache = {"p0": {n: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 1))
                    for n, c in cache["p0"].items()}}
    dec, _ = tm.decode(toks[:, -1:], cache, s - 1)
    _close(dec, full, 5e-4)


def test_moe_refusals_kept():
    cfg = get_config(MOONSHOT).reduced()
    for change in ({"moe_every": 2}, {"family": "hybrid", "ssm_state": 16, "attn_every": 2},
                   {"encoder_layers": 2, "family": "audio"}):
        with pytest.raises(NotImplementedError):
            Model(dataclasses.replace(cfg, **change), {}, device="meta")


def test_full_width_moonshot_schema():
    model = Model(get_config(MOONSHOT), {}, device="meta")
    n = sum(p.numel() for p in model.parameters())
    # param_count() leaves out the shared experts, the routers and the norms
    per_layer = 3 * 2048 * 2816 + 2048 * 64 + 2 * 2048
    assert n == get_config(MOONSHOT).param_count()[0] + 48 * per_layer + 2048
    assert n == 28_888_467_456                    # 57.8 GB in bf16
    assert len(model.layers) == 48 and model.layers[0].moe.w_in.shape == (64, 2048, 1408)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(cls, seed, n=5):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 256, int(rng.integers(2, 21))).astype(np.int32),
                max_new=int(rng.integers(2, 7))) for i in range(n)]


@pytest.mark.parametrize("mode", ["contiguous", "paged", "paged-pressure"])
def test_moonshot_engine_tokens_identical_to_jax_engine(mode):
    kw = dict(slots=2, max_len=48, chunk=8)
    kw.update({"contiguous": {}, "paged": {"paged": True},
               "paged-pressure": {"paged": True, "num_pages": 5}}[mode])
    jrt = JaxRuntime()
    jserver = JaxServer(jax_get_config(MOONSHOT).reduced(),
                        jrt.deploy(jax_make_bundle(MOONSHOT, reduced=True),
                                   mesh=make_host_mesh(data=1)), **kw)
    params = jax.tree.map(np.asarray, jserver.engine.params)
    rt = Runtime(host_env={})
    tserver = Server(get_config(MOONSHOT).reduced(),
                     rt.deploy(make_bundle(MOONSHOT, reduced=True), device="cpu"),
                     device="cpu", params=params, **kw)
    seed = _seed("serve", mode)
    for server, cls in ((jserver, JaxRequest), (tserver, Request)):
        for r in _requests(cls, seed, n=6):
            assert server.submit(r)
        server.run()
    assert all(r.done for r in tserver.requests)
    assert [r.tokens for r in tserver.requests] == [r.tokens for r in jserver.requests]
    assert tserver.engine.prefill_calls == jserver.engine.prefill_calls
    assert tserver.engine.decode_calls == jserver.engine.decode_calls
    assert tserver.scheduler.consolidated_stats() == jserver.scheduler.consolidated_stats()
    rt.cleanup()
    jrt.cleanup()


@pytest.mark.parametrize("flags", [[], ["--paged", "--window", "8"]], ids=["contiguous",
                                                                          "paged-windowed"])
def test_cli_serves_moonshot_on_cpu(capsys, flags):
    assert serve_main(["--arch", MOONSHOT, "--device", "cpu", "--requests", "3",
                       "--max-new", "3", *flags]) == 0
    out = capsys.readouterr().out
    assert "container moonshot-v1-16b-a3b-reduced" in out
    assert "served 3 requests / 9 tokens" in out and "device=cpu" in out


def test_deployment_lists_moe_gmm_as_ported_with_a_cuda_native():
    assert "moe_gmm" in PORTED_OPS
    reg = register_all()
    providers = {impl.provider: impl for impl in reg.decl("moe_gmm").impls}
    assert set(providers) == {"torch-ref", "cuda"}
    assert providers["cuda"].requires_feature == CUDA_KERNELS
    assert providers["cuda"].fn is moe_gmm and providers["torch-ref"].fn is moe_gmm_ref
    rt = Runtime(host_env={})
    container = rt.deploy(make_bundle(MOONSHOT, reduced=True), device="cpu")
    text = container.describe()
    assert "moe_gmm" in text and "moe_gmm            !! not ported" not in text
    report = {r.op: r for r in container.binding.reports}["moe_gmm"]
    assert report.bound == "torch-ref" and "'cuda'" in report.reason
    rt.cleanup()
