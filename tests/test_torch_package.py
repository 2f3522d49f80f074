"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, builds its kernel only with nvcc, and its entry points refuse to
run on the CPU unless asked to."""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from coalign_tpu_torch import runtime
from coalign_tpu_torch.inference import (make_fusion_infer_fn, make_infer_fn,
                                         make_late_infer_fn)
from coalign_tpu_torch.models.zoo import build_model
from coalign_tpu_torch.posegraph import align_poses_batch
from coalign_tpu_torch.tools.noise_sweep import noise_sweep
from coalign_tpu_torch.tools.stage1 import correct_batch_poses, make_stage1_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "coalign_tpu_torch")

# `coalign_tpu` is a prefix of `coalign_tpu_torch`: match the JAX package
# only where it is followed by a dot, a space or the end of the line
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|coalign_tpu)(?:[.\s,]|$)",
    re.M)


def _port_sources():
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]    # build output
        for name in files:
            if name.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        offenders += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                      for m in _FORBIDDEN.finditer(text)]
        if "cpp_extension" in text or "torch/extension.h" in text:
            offenders.append(f"{os.path.relpath(path, REPO)}: cpp_extension")
    assert not offenders, offenders


def test_every_module_imports_with_jax_blocked():
    code = textwrap.dedent("""
        import pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["flax"] = None
        import coalign_tpu_torch, chip_smoke
        names = [m.name for m in pkgutil.walk_packages(
            coalign_tpu_torch.__path__, "coalign_tpu_torch.")]
        for name in names:
            __import__(name)
        leaked = sorted(m for m, mod in sys.modules.items()
                        if mod is not None and (
                            m == "coalign_tpu" or m.startswith("coalign_tpu.")
                            or m.split(".")[0] in ("jax", "flax", "jaxlib")))
        print(len(names), leaked)
        assert not leaked, leaked
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[0]) >= 20


def test_no_module_imports_pil_or_h5py():
    """The camera feed reads PNGs and resizes them itself (data/image_io.py):
    no port module nor chip_smoke.py imports Pillow or h5py, which the
    card's machine lacks, and every module imports with them blocked."""
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:PIL|h5py)(?:[.\s,]|$)",
                         re.M)
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            offenders += [os.path.relpath(path, REPO)
                          for _ in pattern.finditer(f.read())]
    assert not offenders, offenders
    code = textwrap.dedent("""
        import pkgutil, sys
        for blocked in ("PIL", "h5py", "jax", "flax"):
            sys.modules[blocked] = None
        import coalign_tpu_torch, chip_smoke
        for m in pkgutil.walk_packages(coalign_tpu_torch.__path__,
                                       "coalign_tpu_torch."):
            __import__(m.name)
        from coalign_tpu_torch.data import camera_batch, image_io
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for core in ("point_pillar_coalign", "point_pillar_baseline",
                 "point_pillar_intermediate", "point_pillar_disconet"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model({"core_method": core, "args": {}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_infer_fn(torch.nn.Identity(), [], {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_stage1_fn(torch.nn.Identity(), [], {})
    for mode in ("late", "no"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_late_infer_fn(torch.nn.Identity(), [], {}, mode)
    for fusion in ("intermediate", "early", "late", "no", "no_w_uncertainty",
                   "single"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_fusion_infer_fn(torch.nn.Identity(), [], {}, fusion)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        noise_sweep(torch.nn.Identity(), None, [], [], {})
    poses = torch.zeros(1, 2, 6)
    dets = {"box_poses": torch.zeros(1, 2, 4, 3),
            "box_mask": torch.zeros(1, 2, 4, dtype=torch.bool),
            "uncertainty": torch.zeros(1, 2, 4, 3)}
    mask = torch.ones(1, 2, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        align_poses_batch(*dets.values(), poses, mask)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        correct_batch_poses({"lidar_pose": poses, "agent_mask": mask}, dets)
    assert align_poses_batch(*dets.values(), poses, mask,
                             device="cpu").shape == (1, 2, 6)
    with pytest.raises(RuntimeError):
        runtime.resolve_device()
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_build_model_rejects_what_is_not_ported():
    # the two-stage models, the last the port lacked (ROADMAP item 8), are
    # registered; an unknown name raises
    from coalign_tpu_torch.models.zoo import _MODELS
    assert {"fpvrcnn", "fvoxelrcnn"} <= set(_MODELS)
    with pytest.raises(KeyError, match="not ported"):
        build_model({"core_method": "no_such_model", "args": {}},
                    device="cpu")


def test_configure_cuda_sets_full_float32_and_autotuning(monkeypatch):
    # the settings are process-wide: monkeypatch puts them back afterwards
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    runtime.configure_cuda()
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.benchmark
