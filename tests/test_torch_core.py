"""The PyTorch port's container layer held against the JAX package.

  * the copies that must stay equal to their originals: ABI strings, the
    config record, bundles, the pure-Python scheduling classes;
  * deployment on the torch Runtime: a JAX-built bundle deploys on the CPU
    with every ported op on its reference; CUDA without a Hopper card, an
    invalid REPRO_VISIBLE_DEVICES, and a card on which a native would not
    bind or build all raise instead of falling back;
  * the import boundary: every repro_torch module imports with `jax` and
    `repro` blocked.
"""

import inspect
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro.launch.serve as jax_serve
import repro_torch
import repro_torch.core.runtime as torch_runtime
import repro_torch.launch.serve as torch_serve
from repro.configs import get_config as jax_get_config
from repro.core.bundle import Bundle as JaxBundle
from repro.kernels.ops import ABIS as JAX_ABIS
from repro.launch.train import make_bundle as jax_make_bundle
from repro_torch.configs import get_config
from repro_torch.core.abi import AbiIncompatibility, AbiString
from repro_torch.core.bundle import Bundle
from repro_torch.core.env import cuda_index
from repro_torch.core.platform import CUDA_KERNELS, HardwareSpec, Platform
from repro_torch.core.registry import ImplKind, OpImpl, OpRegistry
from repro_torch.core.runtime import DeploymentError, Runtime
from repro_torch.kernels.ops import ABIS, OP_NAMES, PORTED_OPS, register_all
from repro_torch.launch.bundle import make_bundle

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# copies pinned to their originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", sorted(JAX_ABIS))
def test_abi_strings_equal_across_packages(op):
    assert str(ABIS[op]) == str(JAX_ABIS[op])


def test_port_declares_every_jax_op():
    assert set(OP_NAMES) == set(JAX_ABIS)
    assert set(PORTED_OPS) == {"rmsnorm", "attention", "windowed_attention", "chunk_attention",
                               "decode_attention", "moe_gmm"}


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_model_config_dict_equal(reduced):
    ours, theirs = get_config("qwen2.5-14b"), jax_get_config("qwen2.5-14b")
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert ours.to_dict() == theirs.to_dict()
    assert type(ours).from_dict(theirs.to_dict()) == ours
    assert ours.param_count() == theirs.param_count()


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_bundles_identical_and_interchangeable(reduced, tmp_path):
    ours = make_bundle("qwen2.5-14b", reduced=reduced)
    theirs = jax_make_bundle("qwen2.5-14b", reduced=reduced)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.digest == theirs.digest
    # a bundle saved by one package loads in the other, digest intact
    assert Bundle.load(theirs.save(tmp_path / "jax.json")).digest == theirs.digest
    assert JaxBundle.load(ours.save(tmp_path / "torch.json")).digest == ours.digest


@pytest.mark.parametrize("name", ["Request", "BlockAllocator", "PagedPool", "Scheduler"])
def test_scheduling_classes_are_verbatim_copies(name):
    assert inspect.getsource(getattr(torch_serve, name)) == \
        inspect.getsource(getattr(jax_serve, name))


def test_serving_constants_equal():
    for name in ("SERVING_STATS_SCHEMA", "QUEUED", "PREFILLING", "DECODING", "HANDOFF",
                 "DONE", "REJECT_QUEUE_FULL", "REJECT_TOO_LONG"):
        assert getattr(torch_serve, name) == getattr(jax_serve, name), name


# ---------------------------------------------------------------------------
# deployment
# ---------------------------------------------------------------------------

def test_jax_bundle_deploys_on_cpu_with_references():
    rt = Runtime(host_env={})
    container = rt.deploy(jax_make_bundle("qwen2.5-14b", reduced=True), device="cpu")
    try:
        assert container.platform.name == "laptop"
        assert container.device == torch.device("cpu")
        assert set(container.binding) == set(PORTED_OPS)
        assert set(container.unported) == set(OP_NAMES) - set(PORTED_OPS)
        for r in container.binding.reports:
            assert r.kind is ImplKind.REFERENCE and not r.swapped, r
            assert r.bound == "torch-ref"
            assert "cuda_kernels" in r.reason
        text = container.describe()
        assert "not ported" in text and "laptop" in text
        with pytest.raises(KeyError):
            container.binding["ssd_scan"]
    finally:
        rt.cleanup()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rt = Runtime(host_env={})
    with pytest.raises(DeploymentError, match="is_available"):
        rt.deploy(jax_make_bundle("qwen2.5-14b", reduced=True))   # device defaults to cuda
    # nothing was left half-deployed
    rt.deploy(make_bundle("qwen2.5-14b", reduced=True), device="cpu")
    rt.cleanup()


def test_cuda_on_a_non_hopper_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=0: (8, 0))
    with pytest.raises(DeploymentError, match="capability"):
        Runtime(host_env={}).deploy(make_bundle("qwen2.5-14b"), device="cuda")


@pytest.mark.parametrize("value", ["junk", "0,1", "-1", "", "all"])
def test_invalid_visible_devices_is_an_error_on_cuda(value):
    with pytest.raises(DeploymentError, match="REPRO_VISIBLE_DEVICES"):
        Runtime(host_env={"REPRO_VISIBLE_DEVICES": value}).deploy(
            make_bundle("qwen2.5-14b"), device="cuda")


def test_cuda_index_from_env():
    assert cuda_index({}) == 0
    assert cuda_index({"REPRO_VISIBLE_DEVICES": " 3 "}) == 3


def _fake_h100(monkeypatch):
    plat = Platform(name="h100", hardware=HardwareSpec("fake", 0),
                    device=torch.device("cuda", 0),
                    native_features=frozenset({CUDA_KERNELS}))
    monkeypatch.setattr(torch_runtime, "platform_for", lambda dev, index: plat)
    return plat


def _registry(native_kw):
    reg = OpRegistry()
    abi = ABIS["rmsnorm"]
    reg.declare(abi)
    reg.register(OpImpl(abi=abi, kind=ImplKind.REFERENCE, fn=lambda *a, **k: "ref",
                        provider="torch-ref"))
    reg.register(OpImpl(kind=ImplKind.NATIVE, fn=lambda *a, **k: "cuda", provider="cuda",
                        **native_kw))
    return reg


def _rmsnorm_bundle():
    b = make_bundle("qwen2.5-14b")
    return Bundle(name=b.name, tag=b.tag, model_config=b.model_config, recipe=b.recipe,
                  required_ops={"rmsnorm": str(ABIS["rmsnorm"])}, env=b.env)


def test_card_binds_natives_by_default(monkeypatch):
    _fake_h100(monkeypatch)
    built = []
    reg = _registry(dict(abi=ABIS["rmsnorm"], requires_feature=CUDA_KERNELS,
                         prepare=lambda: built.append(1)))
    rt = Runtime(registry=reg, host_env={})
    container = rt.deploy(_rmsnorm_bundle())
    assert container.binding["rmsnorm"]() == "cuda" and built == [1]
    assert container.binding.reports[0].swapped
    rt.cleanup()
    # only an explicit native_ops=False serves the reference on the card
    container = rt.deploy(_rmsnorm_bundle(), native_ops=False)
    assert container.binding["rmsnorm"]() == "ref" and built == [1]
    rt.cleanup()


def test_card_refuses_a_native_it_cannot_bind(monkeypatch):
    _fake_h100(monkeypatch)
    missing = _registry(dict(abi=ABIS["rmsnorm"], requires_feature="cuda_wgmma"))
    with pytest.raises(DeploymentError, match="has a CUDA kernel"):
        Runtime(registry=missing, host_env={}).deploy(_rmsnorm_bundle())


def test_native_with_another_abi_is_refused_at_registration():
    reg = OpRegistry()
    reg.declare(ABIS["rmsnorm"])
    other = AbiString(name="rmsnorm", major=1, minor=0, digest="0" * 12)
    with pytest.raises(AbiIncompatibility):
        reg.register(OpImpl(abi=other, kind=ImplKind.NATIVE, fn=len,
                            requires_feature=CUDA_KERNELS))


def test_card_refuses_a_kernel_that_fails_to_build(monkeypatch):
    _fake_h100(monkeypatch)

    def broken_build():
        raise RuntimeError("Error building extension 'repro_torch_kernels'")

    reg = _registry(dict(abi=ABIS["rmsnorm"], requires_feature=CUDA_KERNELS,
                         prepare=broken_build))
    rt = Runtime(registry=reg, host_env={})
    with pytest.raises(DeploymentError, match="failed to build"):
        rt.deploy(_rmsnorm_bundle())
    assert not reg.frozen


def test_bundle_abi_mismatch_refused():
    b = make_bundle("qwen2.5-14b", reduced=True)
    bad = dict(b.required_ops)
    bad["rmsnorm"] = "rmsnorm/2:0/" + "0" * 12
    bundle = Bundle(name=b.name, tag=b.tag, model_config=b.model_config, recipe=b.recipe,
                    required_ops=bad, env=b.env)
    with pytest.raises(DeploymentError, match="requires"):
        Runtime(host_env={}).deploy(bundle, device="cpu")


def test_register_all_is_idempotent():
    reg = register_all(OpRegistry())
    assert register_all(reg) is reg
    assert len(reg.decl("rmsnorm").impls) == 2


# ---------------------------------------------------------------------------
# import boundary
# ---------------------------------------------------------------------------

def test_port_imports_with_jax_and_repro_blocked():
    modules = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
    assert "repro_torch.launch.serve" in modules and "repro_torch.kernels._build" in modules
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.')) for k in sys.modules\n"
        "               if sys.modules[k] is not None)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
