"""Serving: the whole frame program as a deployment artifact, replayed as a
CUDA graph.

Port of coalign_tpu/serving.py. The frame program of
:func:`coalign_tpu_torch.inference.make_infer_fn` (forward -> decode ->
direction fix -> rotated NMS -> range mask) is traced once with
``torch.export`` at a batch's shapes and written with the model's
parameters; a serving host reloads it with :func:`load_artifact`, which
needs only this module and the kernel module (which registers the IoU
kernel's op): no model zoo, no config parsing.

The parameters stay an argument of the program (the JAX package's
``variables``, coalign_tpu/serving.py:62-66): the program calls the model
through ``torch.func.functional_call``, so another checkpoint's
``params.npz`` of the same state-dict keys swaps in without a new export.

Artifact layout (one directory):
  program.<platform>.pt2   torch.export.save of the program traced on each
                           platform's device ("cuda", "cpu")
  params.npz               the model's state dict, keyed by its names
  meta.json                platforms, the torch version and the batch
                           contract (key -> shape, dtype), checked at load
                           and at every call

On CUDA, :class:`ServingModel` warms the program up on a side stream (the
cuDNN autotuning of runtime.configure_cuda happens there), captures it once
as a CUDA graph on static input buffers and replays that graph for every
request: the counterpart of the JAX package's single ``jax.jit``
(coalign_tpu/serving.py:97-101). The program is exported with its stage
tags (utils/profiling.stage); the capture records a timed CUDA event at
each change of tag, so every replay timestamps its stages on the device,
and a call settles the previous replay's marks into
utils/profiling.STAGE_LOG. Under a profiler a call's host work shows as
three ranges: ``stage/serve_copy_in``, ``stage/serve_replay`` and
``stage/serve_copy_out``. Inside the traced program the NMS runs its
sync-free fixpoint (utils/nms.py), which neither torch.export nor a capture
would take otherwise. Nothing falls back to the eager program: a failed
capture or launch raises.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

# registers torch.ops.coalign_tpu_torch.rotated_iou, which the loaded
# program calls
from coalign_tpu_torch.kernels import rotated_iou as _kernel  # noqa: F401
from coalign_tpu_torch.utils.profiling import (STAGE_LOG, StageMarks,
                                               mark_positions, node_stage,
                                               stage)

_PARAMS = "params.npz"
_META = "meta.json"

# the batch keys the frame program reads (inference.to_device), each with
# the dtype it is read in; a camera batch's nested ``image_inputs`` are all
# float32 and named "image_inputs/<key>" in the batch contract
PROGRAM_KEYS = {"points": torch.float32, "point_mask": torch.bool,
                "agent_mask": torch.bool,
                "pairwise_t_matrix": torch.float32,
                "transformation_matrix": torch.float32}
_IMAGES = "image_inputs"


# where a model that torch.export cannot trace (a host sync or a
# data-dependent shape in its forward) is listed with its reason
REFUSED_ITEM = "ROADMAP §4 'Serving: the models that refuse export'"


def program_file(platform: str) -> str:
    return f"program.{platform}.pt2"


class _Frame(torch.nn.Module):
    """make_infer_fn's frame program over ``model`` as a module, so that
    torch.func.functional_call can run it on other parameters."""

    def __init__(self, model: torch.nn.Module, infer):
        super().__init__()
        self.model = model
        self.infer = infer

    def forward(self, inputs: dict) -> dict:
        return self.infer(inputs)


class _FrameProgram(torch.nn.Module):
    """(params, inputs) -> detections: the frame program with the model's
    parameters and buffers (its state-dict names) taken from ``params``;
    buffers outside the state dict (a model's anchor grid) stay the
    model's, constants of the program. The frame is held outside the
    module's registry, so the exported program carries no weights of its
    own."""

    def __init__(self, frame: _Frame):
        super().__init__()
        self.__dict__["frame"] = frame

    def forward(self, params: dict, inputs: dict) -> dict:
        return torch.func.functional_call(
            self.frame, {f"model.{k}": v for k, v in params.items()},
            (inputs,))


def _lookup(batch: dict, key: str):
    node = batch
    for part in key.split("/"):
        node = node[part]
    return node


def _has(batch: dict, key: str) -> bool:
    try:
        _lookup(batch, key)
        return True
    except (KeyError, TypeError):
        return False


def input_dtypes(batch: dict) -> dict:
    """{contract key: dtype} of the batch keys that the program reads."""
    keys = {k: dt for k, dt in PROGRAM_KEYS.items() if k in batch}
    keys.update({f"{_IMAGES}/{k}": torch.float32
                 for k in batch.get(_IMAGES, {})})
    return keys


def program_inputs(flat: dict, device) -> dict:
    """The program's input dict on ``device`` from {contract key: value}:
    each value a tensor of its dtype, the "image_inputs/<key>" entries
    nested under "image_inputs"."""
    out = {}
    for key, value in flat.items():
        tensor = torch.as_tensor(value, dtype=PROGRAM_KEYS.get(
            key, torch.float32), device=device)
        head, _, leaf = key.partition("/")
        if leaf:
            out.setdefault(head, {})[leaf] = tensor
        else:
            out[key] = tensor
    return out


def batch_inputs(batch: dict, keys, device) -> dict:
    """program_inputs of ``batch``'s values at the contract ``keys``."""
    return program_inputs({k: _lookup(batch, k) for k in keys}, device)


def export_inference(model, batch: dict, anchors, postprocess_cfg: dict,
                     out_dir: str, platforms=("cuda", "cpu")) -> str:
    """Trace make_infer_fn's frame program at ``batch``'s shapes on each
    platform's device and write a deployment artifact to ``out_dir``.
    Returns ``out_dir``.

    ``model`` is left as it was: each platform traces a copy on its device.
    A model whose trace fails (a host sync or a data-dependent shape in its
    forward) raises NotImplementedError naming REFUSED_ITEM; nothing is
    written then."""
    from coalign_tpu_torch.inference import make_infer_fn

    name = type(model).__name__
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    keys = input_dtypes(batch)
    programs = {}
    for platform in platforms:
        dev = torch.device(platform)
        traced = copy.deepcopy(model).to(dev).eval()
        infer = make_infer_fn(traced, anchors, postprocess_cfg, device=dev)
        params = {k: v.to(dev) for k, v in state.items()}
        try:
            # under no_grad, so that make_infer_fn's own no_grad changes
            # nothing and the program stays one flat graph; the stage tags
            # (utils/profiling.stage) kept as node metadata
            with torch.no_grad(), torch.fx.traceback.preserve_node_meta():
                program = torch.export.export(
                    _FrameProgram(_Frame(traced, infer)),
                    (params, batch_inputs(batch, keys, dev)))
        except Exception as err:
            raise NotImplementedError(
                f"{name} does not export on {platform}: "
                f"{type(err).__name__}: {str(err)[:300]} ({REFUSED_ITEM})") \
                from err
        programs[platform] = program
    os.makedirs(out_dir, exist_ok=True)
    for platform, program in programs.items():
        torch.export.save(program, os.path.join(out_dir,
                                                program_file(platform)))
    np.savez(os.path.join(out_dir, _PARAMS),
             **{k: v.numpy() for k, v in state.items()})
    meta = {
        "platforms": list(platforms),
        "torch_version": torch.__version__,
        "batch_spec": {k: {"shape": list(np.shape(_lookup(batch, k))),
                           "dtype": str(dt).replace("torch.", "")}
                       for k, dt in keys.items()},
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        # unsorted: the contract's keys in the order the program takes them
        json.dump(meta, f, indent=1)
    return out_dir


def _constants_on(module: torch.fx.GraphModule, device) -> torch.fx.GraphModule:
    """``module`` (an exported program's) with its constants placed on
    ``device``. A constant that the traced code made from host values (a
    list, a numpy array) stays on the host in the program, which copies it
    to the device at every call: a copy from pageable host memory, which a
    CUDA-graph capture refuses. Placed on the device once, that copy is a
    no-op. The program's metadata asserts (host-side checks of the device
    and dtype each tensor had when traced) are dropped, as they would
    refuse the moved constants."""
    graph = module.graph
    for node in list(graph.nodes):
        if (node.op == "call_function" and node.target
                == torch.ops.aten._assert_tensor_metadata.default):
            graph.erase_node(node)
        elif node.op == "get_attr":
            value = getattr(module, node.target)
            if isinstance(value, torch.Tensor):
                setattr(module, node.target, value.to(device))
    module.recompile()
    return module


_OPS = ("call_function", "call_method", "call_module")


def stage_segments(graph: torch.fx.Graph) -> list:
    """[(node, segment name)]: the operation at which each stage segment
    of an exported program's ``graph`` starts (utils/profiling
    .mark_positions over its operations' stage tags). A program exported
    without tags is one UNTAGGED segment."""
    ops = [n for n in graph.nodes if n.op in _OPS]
    return [(ops[i], name)
            for i, name in mark_positions([node_stage(n) for n in ops])]


class _MarkedRun(torch.fx.Interpreter):
    """Runs a program's nodes in order, recording ``marks`` (a StageMarks
    over its segments) before the first operation of each segment and
    after the last: inside a CUDA-graph capture, each record is an
    event-record node of the graph."""

    def __init__(self, module: torch.fx.GraphModule):
        super().__init__(module)
        segments = stage_segments(module.graph)
        self.marks = StageMarks([name for _, name in segments])
        self._starts = {node: i for i, (node, _) in enumerate(segments)}

    def run_node(self, node):
        if node in self._starts:
            self.marks.record(self._starts[node])
        elif node.op == "output":
            self.marks.record(len(self.marks.names))
        return super().run_node(node)


class ServingModel:
    """A loaded artifact: ``dets = serving_model(batch)``.

    On CUDA the program is captured once as a CUDA graph over static input
    buffers (after a warm-up on a side stream), with a timed event at each
    stage boundary; a call copies the batch in, replays the graph and
    returns copies of the outputs, and each replay's device ms by stage
    reach utils/profiling.STAGE_LOG under the call's index. On the CPU a
    call runs the loaded program."""

    def __init__(self, program, params: dict, meta: dict, device):
        self.meta = meta
        self.device = torch.device(device)
        self.params = params
        self._fn = _constants_on(program.module(), self.device)
        self.graph = None
        self.calls = 0
        self._pending = None
        if self.device.type == "cuda":
            self._capture()

    def _static_inputs(self) -> dict:
        return program_inputs(
            {k: torch.zeros(s["shape"], dtype=getattr(torch, s["dtype"]))
             for k, s in self.meta["batch_spec"].items()}, self.device)

    def _capture(self, warmup: int = 3):
        from coalign_tpu_torch.runtime import configure_cuda

        configure_cuda()
        self.static = self._static_inputs()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(warmup):
                self._fn(self.params, self.static)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.graph = torch.cuda.CUDAGraph()
        marked = _MarkedRun(self._fn)
        with torch.cuda.graph(self.graph), torch.no_grad():
            self.static_out = marked.run(self.params, self.static)
        self.marks = marked.marks
        torch.cuda.synchronize(self.device)

    def check_batch(self, batch: dict):
        spec = self.meta["batch_spec"]
        missing = sorted(k for k in spec if not _has(batch, k))
        if missing:
            raise ValueError(f"batch is missing keys {missing}; the "
                             f"artifact was exported with {sorted(spec)}")
        for k, s in spec.items():
            got = list(np.shape(_lookup(batch, k)))
            if got != s["shape"]:
                raise ValueError(
                    f"batch[{k!r}] has shape {got}, artifact expects "
                    f"{s['shape']} (exported programs are fixed-shape; "
                    f"re-export for a different batch contract)")

    def __call__(self, batch: dict) -> dict:
        keys = self.meta["batch_spec"]
        with stage("stage/serve_copy_in"):
            self.check_batch(batch)
            if self.graph is None:
                inputs = batch_inputs(batch, keys, self.device)
            else:
                if self._pending is not None:
                    # the last replay's marks, before this replay records
                    # them again: logged if done, else dropped
                    STAGE_LOG.settle(self._pending)
                # each host value straight into its static buffer: one
                # copy, cast to the buffer's dtype on the way
                for k in keys:
                    _lookup(self.static, k).copy_(
                        torch.as_tensor(_lookup(batch, k)))
        with stage("stage/serve_replay"):
            if self.graph is None:
                with torch.no_grad():
                    out = self._fn(self.params, inputs)
            else:
                self.graph.replay()
                self._pending = STAGE_LOG.submit(self.calls, self.marks)
        self.calls += 1
        with stage("stage/serve_copy_out"):
            if self.graph is None:
                return out
            return {k: v.clone() for k, v in self.static_out.items()}


def load_params(artifact_dir: str, device) -> dict:
    npz = np.load(os.path.join(artifact_dir, _PARAMS))
    return {k: torch.from_numpy(npz[k]).to(device) for k in npz.files}


def load_artifact(artifact_dir: str, device=None) -> ServingModel:
    """Reload an :func:`export_inference` artifact onto ``device`` (CUDA
    unless the caller names one; a device whose platform the artifact was
    not exported for is refused). Needs only this module and the kernel
    module: no model zoo and no config package."""
    from coalign_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    with open(os.path.join(artifact_dir, _META)) as f:
        meta = json.load(f)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"the artifact was exported for {meta['platforms']},"
                         f" not {dev.type}")
    program = torch.export.load(os.path.join(artifact_dir,
                                             program_file(dev.type)))
    return ServingModel(program, load_params(artifact_dir, dev), meta, dev)
