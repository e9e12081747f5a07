"""The port's spans (``utils/trace.py``): the names a pipeline call emits
under torch.profiler and how they nest, the null context outside a
profile, and the build spans of the cached host functions, which open only
on a miss.  The CPU routes pass through the same models / ops / tables
code as the card's; the card's ``ia.native.*`` spans are checked against
the launch counters in ``tests/test_torch_port_cuda.py``."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from interpolate_antialiasing_tpu_torch import native
from interpolate_antialiasing_tpu_torch.models import (ImageNetEvalPipeline,
                                                       ImageNetTrainPipeline, VideoDownscaler)
from interpolate_antialiasing_tpu_torch.ops import crop_cuda as cc
from interpolate_antialiasing_tpu_torch.ops import pil_exact as pe
from interpolate_antialiasing_tpu_torch.ops import plans
from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec
from interpolate_antialiasing_tpu_torch.utils import trace
from interpolate_antialiasing_tpu_torch.utils.inspect import launch_counts

PACKAGE = Path(__file__).resolve().parents[1] / "interpolate_antialiasing_tpu_torch"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(shape=(2, 3, 60, 124), seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) * 255).to(torch.uint8)


BOXES = torch.tensor([[0.1, 0.05, 0.9, 0.8], [0.0, 0.2, 1.0, 0.7]])


def _eval():
    pipe, x = ImageNetEvalPipeline(size=(22, 22), short_side=26), _batch((2, 3, 44, 90))
    return lambda: pipe(x)


def _train(flip):
    pipe, x = ImageNetTrainPipeline(size=(28, 28)), _batch()
    return lambda: pipe.apply(x, BOXES, flip)


def _video():
    model, x = VideoDownscaler((12, 20)), torch.rand(1, 3, 24, 40).to(torch.bfloat16)
    return lambda: model(x)


CALLS = {"eval": _eval, "train": lambda: _train(torch.tensor([True, False])),
         "train_noflip": lambda: _train(None), "video": _video}

# each span of one warm call, with the innermost program span that holds it
NESTING = {
    "eval": [("ia.models.eval", None), ("ia.ops.resize", "ia.models.eval"),
             ("ia.ops.pil_exact", "ia.ops.resize"), ("ia.tables.pil", "ia.ops.pil_exact"),
             ("ia.models.normalize", "ia.models.eval")],
    "train": [("ia.models.train", None), ("ia.ops.crop_and_resize", "ia.models.train"),
              ("ia.tables.crop_dense", "ia.ops.crop_and_resize"),
              ("ia.tables.crop_dense", "ia.ops.crop_and_resize"),
              ("ia.models.normalize", "ia.models.train")],
    "train_noflip": [("ia.models.train", None), ("ia.ops.crop_and_resize", "ia.models.train"),
                     ("ia.ops.crop_windowed", "ia.ops.crop_and_resize"),
                     ("ia.tables.crop_windowed", "ia.ops.crop_windowed"),
                     ("ia.models.normalize", "ia.models.train")],
    "video": [("ia.models.video", None), ("ia.ops.resize_plane", "ia.models.video"),
              ("ia.tables.resize2d", "ia.ops.resize_plane")],
}


def _spans(fn):
    """``[(name, start, end)]`` of the ``ia.`` spans of one profiled call."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("ia.")), key=lambda s: (s[1], -s[2]))


def _with_parents(spans):
    out, stack = [], []
    for name, s, e in spans:
        while stack and stack[-1][2] <= s:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out


@pytest.mark.parametrize("call", sorted(CALLS))
def test_a_pipeline_call_emits_its_spans_inside_its_models_span(call):
    fn = CALLS[call]()
    fn()  # tables and plans built outside the profile
    spans = _spans(fn)
    assert _with_parents(spans) == NESTING[call]
    name, s0, e0 = spans[0]
    assert name.startswith("ia.models.")
    assert all(s0 <= s <= e <= e0 for _, s, e in spans[1:])


def test_the_video_downscaler_emits_its_models_span():
    """A cold call: the plane route's builds (the streaming plan, which a
    short launch refuses before any table, then the tile plan and both
    passes' tables) open inside its tables span, inside
    ``ia.models.video``."""
    fn = _video()
    plans.tables.cache_clear()
    plans.plan2d.cache_clear()
    plans.plan2d_stream.cache_clear()
    assert _with_parents(_spans(fn)) == NESTING["video"] + [
        ("ia.build.plan2d_stream", "ia.tables.resize2d"),
        ("ia.build.plan2d", "ia.tables.resize2d"), ("ia.build.tables", "ia.build.plan2d"),
        ("ia.build.tables", "ia.build.plan2d")]


def test_without_a_profiler_a_span_is_the_shared_null_context(monkeypatch):
    assert trace.span("ia.ops.resize") is trace.span("ia.models.eval") is trace._OFF

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for make in CALLS.values():
        make()()
    with pytest.raises(AssertionError):
        with profile(activities=[ProfilerActivity.CPU]):
            trace.span("ia.ops.resize")


def test_an_exception_closes_its_span():
    @trace.spanned("ia.ops.failing")
    def failing():
        with trace.span("ia.tables.inner"):
            raise ValueError("refused")

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            failing()
        with trace.span("ia.models.after"):
            pass
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("ia."))
    assert [n for _, _, n in spans] == ["ia.ops.failing", "ia.tables.inner", "ia.models.after"]
    assert spans[0][1] <= spans[2][0]


def _geometry():
    return cc._table_geometry(60, 124, 28, 28, "bilinear", True, (1.0, 1.0), "pil_int8")


def _axes():
    return tuple(ax for ax, _ in _geometry())


def _plane_specs():
    return make_axis_spec(60, 28, "bilinear"), make_axis_spec(124, 28, "bilinear")


def _int_table_pair():
    return pe._int_tables(124, 60, "bilinear", None, 22), pe._int_tables(60, 30, "bilinear",
                                                                        None, 22)


CACHED = {
    "_int_tables": (pe._int_tables, lambda: pe._int_tables(90, 26, "bilinear", None, 22)),
    "_table_tensor": (pe._table_tensor, lambda: pe._table_tensor(
        np.arange(6, dtype=np.int32).tobytes(), (2, 3), torch.device("cpu"))),
    "_plan_2pass_keyed": (plans._plan_2pass_keyed,
                          lambda: plans.plan_pil_2pass(*_int_table_pair(), 6, 60, 124)),
    "_table_geometry": (cc._table_geometry, _geometry),
    "_crop_plan": (cc._crop_plan, lambda: cc._crop_plan(
        _geometry()[0][1], 60, 28, _axes()[0].T, 2, 3, 124, 132, True, 1)),
    "_table_plan": (cc._table_plan, lambda: cc._table_plan(_axes(), 2, 132)),
    "_table_blocks": (cc._table_blocks, lambda: cc._table_blocks(2, _axes(), (1, 1))),
    "tables": (plans.tables, lambda: plans.tables(_plane_specs()[0])),
    "tables_on": (plans.tables_on, lambda: plans.tables_on(_plane_specs()[1], torch.device("cpu"))),
    "plan2d": (plans.plan2d, lambda: plans.plan2d(*_plane_specs(), 2, 3)),
    "stream_tables": (plans.stream_tables, lambda: plans.stream_tables(_plane_specs()[0], 8)),
    "stream_tables_on": (plans.stream_tables_on, lambda: plans.stream_tables_on(
        _plane_specs()[0], 8, torch.device("cpu"))),
    "plan2d_stream": (plans.plan2d_stream,
                      lambda: plans.plan2d_stream(*_plane_specs(), 2, 4096, 132)),
}


@pytest.mark.parametrize("name", sorted(CACHED))
def test_a_cached_function_emits_its_build_span_only_on_a_miss(name):
    cached, call = CACHED[name]
    cached.cache_clear()
    builds = [[n for n, _, _ in _spans(call)].count(f"ia.build.{name}") for _ in range(2)]
    assert builds == [1, 0]


def test_the_memo_of_a_host_table_emits_its_build_span_only_on_a_miss():
    a = np.arange(5, dtype=np.int32)
    a.setflags(write=False)
    made = []
    builds = [[n for n, _, _ in _spans(lambda: plans.memo(a, "test", lambda: made.append(1)))]
              for _ in range(2)]
    assert builds == [["ia.build.memo"], []] and made == [1]


def _native_launches(tree) -> set:
    """The kernel names a module passes to ``native.launch`` and
    ``native.launch_planes``: every string in their first argument."""
    names = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("launch", "launch_planes")
                and isinstance(node.func.value, ast.Name) and node.func.value.id == "native"):
            names |= {c.value for c in ast.walk(node.args[0]) if isinstance(c, ast.Constant)}
    return names


def test_span_names_name_a_layer_and_the_launch_counters_kernels():
    """Every span names one of the five layers; the ``ia.native`` span of a
    launch is named by the kernel ``native.launch`` is given, and the
    kernels the routes launch are the launch counters' keys."""
    names, launched = set(), set()
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        names |= set(re.findall(r'span(?:ned)?\(f?"(ia\.[^"{<]+)', text))
        launched |= _native_launches(ast.parse(text))
    assert {n.split(".")[1] for n in names} == {"models", "ops", "tables", "build", "native"}
    assert {n for n in names if n.startswith("ia.native")} == {"ia.native."}
    assert launched == set(launch_counts())


ROUTE_MODULES = ("cuda_resize", "pil_exact", "crop_cuda")


def _route_reads(path: Path, route: str) -> list[str]:
    """The underscore names that the module at ``path`` reads of the route
    module ``route``: ``from .route import _name`` and ``alias._name`` where
    ``alias`` is bound to it by an import."""
    tree = ast.parse(path.read_text())
    aliases, reads = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[-1] == route:
                reads += [a.name for a in node.names if a.name.startswith("_")]
            aliases |= {a.asname or a.name for a in node.names if a.name == route}
        elif isinstance(node, ast.Import):
            aliases |= {a.asname for a in node.names if a.name.split(".")[-1] == route}
    reads += [node.attr for node in ast.walk(tree)
              if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
              and node.value.id in aliases and node.attr.startswith("_")]
    return reads


@pytest.mark.parametrize("module", ["ops/pil_exact.py", "ops/crop_cuda.py", "utils/inspect.py"])
def test_a_route_reads_no_private_name_of_the_float_route(module):
    """The Pillow and crop routes and the report read the plans, tables and
    launches they share from ``ops/plans.py`` and ``native.py``, none of
    them from ``ops/cuda_resize.py``."""
    assert _route_reads(PACKAGE / module, "cuda_resize") == []


def test_the_plan_layer_imports_no_route_module():
    tree = ast.parse((PACKAGE / "ops" / "plans.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            imported |= {(node.module or "").split(".")[-1]} | {a.name for a in node.names}
        elif isinstance(node, ast.Import):
            imported |= {a.name.split(".")[-1] for a in node.names}
    assert not imported & {*ROUTE_MODULES, "resize", "crop"}
