"""The port's serving engine held against the JAX one, on the CPU.

  * end to end: one seeded request set served by the JAX `Server`
    (JaxEngine) and by the port's `Server` (TorchEngine) with the same
    weights gives identical greedy tokens, in both prefill modes;
  * policy: the copied `Scheduler` driven by a fake engine and a fake
    clock — admission, queue-depth rejection, prefill/decode interleave,
    the step-count invariants;
  * the engine's options that are not ported raise, the CLI serves on
    the CPU, and it serves the published widths when asked for the card.
"""

import math
import zlib

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import Runtime as JaxRuntime
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import Server as JaxServer
from repro.launch.train import make_bundle as jax_make_bundle
from repro_torch.configs import get_config
from repro_torch.core.runtime import DeploymentError, Runtime
from repro_torch.launch.bundle import make_bundle
from repro_torch.launch.serve import (
    REJECT_QUEUE_FULL,
    REJECT_TOO_LONG,
    Request,
    Scheduler,
    Server,
    TorchEngine,
    main,
    serves_reduced,
)

ARCH = "qwen2.5-14b"


def _seed(*parts) -> int:
    return zlib.crc32(":".join(map(str, parts)).encode()) & 0x7FFFFFFF


def _requests(cls, seed, n=5):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 256, int(rng.integers(2, 21))).astype(np.int32),
                max_new=int(rng.integers(2, 7))) for i in range(n)]


@pytest.fixture(scope="module")
def jax_container():
    rt = JaxRuntime()
    container = rt.deploy(jax_make_bundle(ARCH, reduced=True), mesh=make_host_mesh(data=1))
    yield container
    rt.cleanup()


@pytest.fixture()
def torch_container():
    rt = Runtime(host_env={})
    yield rt.deploy(make_bundle(ARCH, reduced=True), device="cpu")
    rt.cleanup()


@pytest.mark.parametrize("prefill_mode", ["chunked", "decode"])
def test_greedy_tokens_identical_to_jax_engine(jax_container, torch_container, prefill_mode):
    kw = dict(slots=2, max_len=48, chunk=8, prefill_mode=prefill_mode)
    jserver = JaxServer(jax_get_config(ARCH).reduced(), jax_container, **kw)
    params = jax.tree.map(np.asarray, jserver.engine.params)
    tserver = Server(get_config(ARCH).reduced(), torch_container, device="cpu",
                     params=params, **kw)
    seed = _seed("serve", prefill_mode)
    for server, cls in ((jserver, JaxRequest), (tserver, Request)):
        for r in _requests(cls, seed):
            assert server.submit(r)
        server.run()
    jt = [r.tokens for r in jserver.requests]
    tt = [r.tokens for r in tserver.requests]
    assert all(r.done for r in tserver.requests)
    assert tt == jt
    assert tserver.engine.prefill_calls == jserver.engine.prefill_calls
    assert tserver.engine.decode_calls == jserver.engine.decode_calls


def test_seeded_engine_is_deterministic(torch_container):
    cfg = get_config(ARCH).reduced()
    tokens = []
    for _ in range(2):
        server = Server(cfg, torch_container, slots=2, max_len=32, chunk=4, device="cpu",
                        seed=7)
        for r in _requests(Request, _seed("det"), n=3):
            server.submit(r)
        server.run()
        tokens.append([r.tokens for r in server.requests])
    assert tokens[0] == tokens[1]


@pytest.mark.parametrize("option", [{"paged": True}, {"window": 8}, {"quantize": "int8"}])
def test_unported_engine_options_raise(torch_container, option):
    with pytest.raises(NotImplementedError):
        TorchEngine(get_config(ARCH).reduced(), torch_container, slots=1, max_len=16,
                    device="cpu", **option)


def test_engine_refuses_another_device_than_the_container(torch_container):
    with pytest.raises(ValueError, match="container"):
        TorchEngine(get_config(ARCH).reduced(), torch_container, slots=1, max_len=16)


def test_cli_serves_on_cpu(capsys):
    assert main(["--device", "cpu", "--requests", "3", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out and "device=cpu" in out


@pytest.mark.parametrize("device,reduced", [("cpu", True), ("cuda", False), ("cuda:0", False)])
def test_cli_chooses_the_config_from_the_device(device, reduced):
    # the card's kernels take head_dim 64 or 128: the published widths
    assert serves_reduced(device) is reduced
    cfg = get_config(ARCH).reduced() if reduced else get_config(ARCH)
    assert (cfg.head_dim in (64, 128)) is not reduced


def test_cli_on_cuda_deploys_the_published_widths(monkeypatch):
    # here there is no card, so the deployment refuses; what it was asked
    # to deploy is the full-width bundle
    from repro_torch.launch import serve as serve_mod

    deployed = []
    real = serve_mod.Runtime.deploy

    def spy(self, bundle, **kw):
        deployed.append((bundle.model_config["head_dim"], kw.get("device")))
        return real(self, bundle, **kw)

    monkeypatch.setattr(serve_mod.Runtime, "deploy", spy)
    with pytest.raises(DeploymentError):
        main(["--device", "cuda"])
    assert deployed == [(get_config(ARCH).head_dim, "cuda")]


# ---------------------------------------------------------------------------
# policy: the copied Scheduler against a fake engine
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class FakeEngine:
    """Duck-typed TorchEngine: argmax == fed token + 1, a call log, and a
    clock that advances one unit per step."""

    vocab = 16

    def __init__(self, *, slots=2, max_len=32, chunk=4, prefill_mode="chunked", clock=None):
        self.slots, self.max_len, self.chunk = slots, max_len, chunk
        self.prefill_mode, self.clock = prefill_mode, clock
        self.log = []

    @property
    def prefill_unit(self):
        return self.chunk if self.prefill_mode == "chunked" else 1

    def _logits(self, token):
        v = np.zeros(self.vocab)
        v[(int(token) + 1) % self.vocab] = 1.0
        return v

    def prefill_step(self, slot, tokens, pos):
        self.log.append(("prefill", slot, len(tokens), pos))
        if self.clock is not None:
            self.clock.t += 1.0
        return self._logits(tokens[-1]) if self.prefill_mode == "chunked" else None

    def decode_step(self, tokens, pos, active):
        self.log.append(("decode", tuple(np.flatnonzero(active))))
        if self.clock is not None:
            self.clock.t += 1.0
        out = np.zeros((self.slots, self.vocab))
        for s in np.flatnonzero(active):
            out[s] = self._logits(tokens[s, 0])
        return out


def _mk(rid, plen, max_new=3):
    return Request(rid=rid, prompt=np.arange(plen, dtype=np.int32), max_new=max_new)


def _drain(sched, max_ticks=10_000):
    while not sched.idle:
        sched.tick()
        max_ticks -= 1
        assert max_ticks > 0, "scheduler failed to drain"


def test_admission_rejects_on_queue_depth():
    sched = Scheduler(FakeEngine(slots=1), queue_depth=2)
    assert sched.submit(_mk(0, 4)) and sched.submit(_mk(1, 4))
    assert not sched.submit(_mk(2, 4))
    assert sched.rejected[REJECT_QUEUE_FULL] == 1
    _drain(sched)
    assert sched.completed == 2


def test_admission_rejects_unservable_budget():
    sched = Scheduler(FakeEngine(chunk=4, max_len=16))
    assert not sched.submit(_mk(0, 10, max_new=8))    # 10 + 8 > 16
    assert not sched.submit(_mk(1, 0))                # empty prompt
    assert sched.submit(_mk(2, 15, max_new=1))        # exactly fits
    assert sched.rejected[REJECT_TOO_LONG] == 2


def test_interleave_keeps_decode_flowing_during_prefill():
    eng = FakeEngine(slots=2, chunk=2)
    sched = Scheduler(eng, interleave=1)
    sched.submit(_mk(0, 2, max_new=6))
    sched.submit(_mk(1, 6, max_new=2))
    per_tick = []
    while not sched.idle:
        eng.log.clear()
        sched.tick()
        per_tick.append(list(eng.log))
    assert sched.completed == 2
    assert all(sum(e[0] == "prefill" for e in t) <= 1 for t in per_tick)
    for t in per_tick[1:3]:
        assert {"prefill", "decode"} <= {e[0] for e in t}


@pytest.mark.parametrize("prefill_mode", ["chunked", "decode"])
def test_step_count_invariants_and_ttft(prefill_mode):
    clock = FakeClock()
    eng = FakeEngine(slots=1, chunk=4, max_len=64, prefill_mode=prefill_mode, clock=clock)
    sched = Scheduler(eng, clock=clock)
    reqs = [_mk(0, 8, 2), _mk(1, 7, 3)]
    for r in reqs:
        assert sched.submit(r)
    _drain(sched)
    for r in reqs:
        if prefill_mode == "chunked":
            assert r.prefill_steps == math.ceil(r.prompt_len / 4)
            assert r.decode_steps == r.max_new - 1
        else:
            assert r.prefill_steps == r.prompt_len
            assert r.decode_steps == r.max_new
        assert len(r.tokens) == r.max_new
    assert reqs[0].ttft == (2.0 if prefill_mode == "chunked" else 9.0)
