"""The port's package surfaces against the reference's: every public name of
``repro``, ``repro.core``, ``repro.frontend``, ``repro.kernels.ops`` and
``repro.train`` (their ``__all__``, or the public names the package's
``__init__.py`` imports where it has none, as ``repro.train``,
``repro.serve``, ``repro.models`` and ``repro.configs`` do) resolves in the
port's counterpart: by its own name, through the analogue named in
``ANALOGUES``, or else it stands in ``NO_COUNTERPART`` with its reason.
"""
import importlib
import inspect
import warnings

import pytest

import repro
import repro_torch

PACKAGES = [
    ("repro", "repro_torch"),
    ("repro.core", "repro_torch.core"),
    ("repro.frontend", "repro_torch.frontend"),
    ("repro.kernels.ops", "repro_torch.kernels.ops"),
    ("repro.train", "repro_torch.train"),
    ("repro.serve", "repro_torch.serve"),
    ("repro.models", "repro_torch.models"),
    ("repro.configs", "repro_torch.configs"),
    ("repro.data", "repro_torch.data"),
    ("repro.checkpoint", "repro_torch.checkpoint"),
    ("repro.distributed", "repro_torch.distributed"),
]

#: (reference package, name) -> the port's name for it, where the reference's
#: is JAX's: a jaxpr becomes an ATen graph, a primitive an ATen op
ANALOGUES = {
    ("repro.frontend", "lower_jaxpr"): "lower_graph",
    ("repro.frontend", "LoweredJaxpr"): "LoweredGraph",
    ("repro.frontend", "SUPPORTED_PRIMITIVES"): "SUPPORTED_OPS",
    ("repro.frontend", "UNARY_PRIMS"): "UNARY_OPS",
    ("repro.frontend", "BINARY_PRIMS"): "BINARY_OPS",
    ("repro.frontend", "REDUCE_PRIMS"): "REDUCE_OPS",
    ("repro.frontend", "STRUCTURAL_PRIMS"): "STRUCTURAL_OPS",
    ("repro.frontend", "IDENTITY_PRIMS"): "IDENTITY_OPS",
    ("repro.frontend", "CALL_PRIMS"): "CONTROL_FLOW_OPS",
}

#: names with no counterpart in the port, each with its reason
NO_COUNTERPART = {
    ("repro.kernels.ops", "on_tpu"):
        "the port targets one NVIDIA card, never a TPU; a wrapper picks its "
        "kernel by its tensors' device (core.device.input_device)",
    ("repro.kernels.ops", "default_interpret"):
        "CUDA kernels have no interpret mode: CPU tensors run the plain "
        "version (kernels/ref.py) instead",
}


def _public_names(mod):
    """``__all__``, or the non-module public names the package imports."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not inspect.ismodule(v))


@pytest.mark.parametrize("ref_name,port_name", PACKAGES, ids=[p for p, _ in PACKAGES])
def test_every_reference_name_resolves_in_the_port(ref_name, port_name):
    ref = importlib.import_module(ref_name)
    port = importlib.import_module(port_name)
    missing = []
    for name in _public_names(ref):
        if (ref_name, name) in NO_COUNTERPART:
            assert not hasattr(port, name)
            continue
        target = ANALOGUES.get((ref_name, name), name)
        if not hasattr(port, target):
            missing.append(f"{name} (as {target})" if target != name else name)
    assert not missing, f"{port_name} lacks {missing}"


@pytest.mark.parametrize("port_name", ["repro_torch", "repro_torch.core", "repro_torch.frontend",
                                       "repro_torch.kernels.ops", "repro_torch.train",
                                       "repro_torch.distributed"])
def test_all_lists_only_names_that_resolve(port_name):
    port = importlib.import_module(port_name)
    assert len(set(port.__all__)) == len(port.__all__)
    assert [n for n in port.__all__ if not hasattr(port, n)] == []


def test_the_reference_all_lists_come_first_in_order():
    """The port's ``__all__`` opens with the reference's, name for name."""
    for ref_name, port_name in [("repro", "repro_torch"), ("repro.core", "repro_torch.core")]:
        ref = importlib.import_module(ref_name).__all__
        port = importlib.import_module(port_name).__all__
        assert port[:len(ref)] == ref


def test_version_is_the_reference_version():
    assert repro_torch.__version__ == repro.__version__


def test_issue_imports():
    from repro_torch import Request, ServeEngine, VerificationError  # noqa: F401
    from repro_torch.core import DeviceSpec, MemoryPlan, tune  # noqa: F401
    from repro_torch.train import Trainer, make_train_step  # noqa: F401


@pytest.mark.parametrize("name,home,attr", [
    ("GraphBuilder", "repro_torch.core", "GraphBuilder"),
    ("trace", "repro_torch.core", "trace"),
    ("reference_execute", "repro_torch.core", "reference_execute"),
    ("lower_jaxpr", "repro_torch.frontend", "lower_graph"),
    ("SUPPORTED_PRIMITIVES", "repro_torch.frontend", "SUPPORTED_OPS"),
])
def test_deprecated_flat_names_resolve_to_their_analogues(name, home, attr):
    """The reference's deprecated flat names (``repro._DEPRECATED``) all
    resolve in ``repro_torch``; those the port does not export directly warn
    once, naming the home."""
    assert name in repro._DEPRECATED
    want = getattr(importlib.import_module(home), attr)
    repro_torch._warned.discard(name)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = getattr(repro_torch, name)
    assert got is want
    if name in repro_torch._DEPRECATED:
        assert any(issubclass(w.category, DeprecationWarning) and home in str(w.message)
                   for w in caught)
    assert name in dir(repro_torch)


def test_unknown_attribute_raises():
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        repro_torch.nope  # noqa: B018
