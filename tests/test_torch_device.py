"""The port stands alone and runs where it is told to.

* Importing every ``repro_torch`` module loads neither jax nor ``repro``.
* ``compile_module``, ``reference_execute`` and the measuring helpers
  (``emit_group``, ``measure_group``, ``measure_kernel``) target the card
  by default and raise when there is none; they never fall back to the CPU.
* The models' constructors (``init_params``, ``init_cache``,
  ``init_paged_cache``, ``params_from_reference``) target the card by
  default and raise when there is none; ``forward`` and the decode steps
  run where the parameters lie.
* A kernel wrapper launches on CUDA tensors, runs its plain version on CPU
  tensors, and refuses tensors on any other device.  Called with no tensors
  it targets the card unless asked for the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import compile_module, reference_execute
from repro_torch.core.measure import emit_group, measure_group, measure_kernel
from repro_torch.graphs import nmt_graph, random_feeds

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks", "graphs"))
print(len(names), leaked)
wanted = ("repro_torch.kernels.ops", "repro_torch.frontend.api", "repro_torch.frontend.aten_lower",
          "repro_torch.configs", "repro_torch.configs.base", "repro_torch.models",
          "repro_torch.models.transformer", "repro_torch.models.ssm")
sys.exit(1 if leaked or len(names) < 15 or any(w not in names for w in wanted) else 0)
"""


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = nmt_graph()
    with pytest.raises(RuntimeError, match="cuda"):
        compile_module(module)
    with pytest.raises(RuntimeError, match="cuda"):
        reference_execute(module, random_feeds(module, np.random.RandomState(0)))
    with pytest.raises(ValueError, match="unsupported device"):
        compile_module(module, device="meta")
    assert compile_module(module, device="cpu").stats.device == "cpu"
    members = [i for i in module.instructions
               if i.opcode not in ("parameter", "constant") and not i.is_library_call]
    for call in (lambda **kw: emit_group(members, **kw),
                 lambda **kw: measure_group(members, repeats=1, **kw)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
        assert call(device="cpu") is not None
    kernel = emit_group(members, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        measure_kernel(kernel)
    assert measure_kernel(kernel, device="cpu", repeats=1) > 0.0


def test_kernel_wrapper_refuses_other_devices():
    compiled = compile_module(nmt_graph(), device="cpu")
    (kernel,) = compiled.kernels
    meta = [torch.empty(i.shape, device="meta") for i in kernel.inputs]
    with pytest.raises(ValueError, match="meta"):
        kernel(*meta)
    cpu = [torch.zeros(i.shape) for i in kernel.inputs]
    outs = kernel(*cpu)
    assert [tuple(o.shape) for o in outs] == [tuple(r.shape) for r in kernel.outputs]
    assert kernel.fn.launches == 0          # the plain version is not a launch
    with pytest.raises(RuntimeError, match="no CUDA library"):
        kernel.fn.launch(*cpu, device=torch.device("cpu"))


def test_kernel_with_no_inputs_targets_the_card(monkeypatch):
    compiled = compile_module(nmt_graph(), device="cpu")
    program = compiled.kernels[0].fn
    monkeypatch.setattr(program, "plain", lambda *a, device: ("plain", device))
    monkeypatch.setattr(program, "launch", lambda *a, device: ("launch", device))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        program()
    assert program(device="cpu") == ("plain", torch.device("cpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        program(device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert program() == ("launch", torch.device("cuda"))


def test_models_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch import models
    from repro_torch.configs import get_config, reduced_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(get_config("hymba-1.5b"))
    builders = {
        "init_params": lambda **kw: models.init_params(cfg, 0, **kw),
        "init_cache": lambda **kw: models.init_cache(cfg, 2, 8, **kw),
        "init_paged_cache": lambda **kw: models.init_paged_cache(cfg, 4, 4, 2, **kw),
        "params_from_reference": lambda **kw: models.params_from_reference(
            {"w": np.ones((2, 3), np.float32)}, **kw),
    }
    for name, build in builders.items():
        with pytest.raises(RuntimeError, match="cuda"):
            build()
        with pytest.raises(ValueError, match="unsupported device"):
            build(device="meta")
        on_cpu = build(device="cpu")
        assert all(t.device.type == "cpu" for t in models.module.tree_leaves(on_cpu)), name
    params = builders["init_params"](device="cpu")
    cache = builders["init_cache"](device="cpu")
    logits, _ = models.decode_step(params, cache, np.array([1, 2]), 0, cfg)
    assert logits.device.type == "cpu"
    assert models.forward(params, {"tokens": np.ones((1, 4), np.int32)}, cfg).device.type == "cpu"
