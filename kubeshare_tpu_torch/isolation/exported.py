"""A tenant's program as a ``torch.export`` artifact — what StableHLO is to
the JAX proxy (``kubeshare_tpu/isolation/client.py``'s
``_trace_and_compile`` and the proxy's ``_install_program``).

Client side, :func:`export_program`: the tenant's function is traced
abstractly — ``make_fx`` over fake tensors, so nothing runs and no device
is touched — into a straight-line aten graph, backward pass included (a
``torch.autograd.grad`` in the function is traced through). The port's
kernels appear in it as their custom ops (``kubeshare_tpu_torch::``), and
the fused Adam step stays an in-place op on its inputs. The graph is
exported (``torch.export.export``) and saved into bytes.

Proxy side, :func:`load_program`: the bytes are held to what a program may
be before anything is loaded, then loaded with ``torch.export.load`` as a
canonical archive the proxy writes itself:

- only the schema format (JSON) is read. An archive that carries anything
  else — weights, constants, custom objects, guard code, a pickled
  ``GraphModule`` — is refused, and the example inputs the exporter
  pickles are dropped unread: ``torch.export.load`` unpickles them with
  ``weights_only=False`` when the safe loader refuses them;
- every op must be an ``aten`` or ``prims`` op, one of the port's own
  custom ops, or a higher-order op that export itself emits around them;
  and an op's schema must take and give values only (tensors, numbers,
  dtypes, devices, and lists and optionals of them): an op that names a
  file (``aten.from_file``, ``aten.save``), takes a storage, a stream, a
  future or a script object, or prints, is refused, so a graph reaches
  nothing of the proxy's host but its own tensors;
- every device in the graph is rewritten to the proxy's, so a graph
  traced on the CPU (as a tenant with no card traces it) runs on the
  card, and the other way round;
- per-node metadata (stack traces, tracer ids) is dropped: it carries no
  semantics, and the program's key — the sha256 of the canonical archive
  — is then the same for identical tenants, who share one cost model.
"""

from __future__ import annotations

import hashlib
import io
import json
import operator
import threading
import zipfile

import torch

from ..ops import flash_attention as _flash  # noqa: F401  (registers the ops)
from ..ops.fused_adam import OP_NAMESPACE
from ..utils.tree import TreeDef, tree_flatten, tree_unflatten
from .programs import dtype_name, torch_dtype

#: op namespaces a program may call
ALLOWED_NAMESPACES = ("aten", "prims", OP_NAMESPACE)
#: higher-order ops that export emits around a mutating custom op; the op
#: they wrap is held to ALLOWED_NAMESPACES too
ALLOWED_HIGHER_ORDER = ("auto_functionalized", "auto_functionalized_v2")
#: what an allowed op's arguments and results may be (JIT type kinds), and
#: lists and optionals of them
_VALUE_KINDS = frozenset((
    "TensorType", "IntType", "SymIntType", "FloatType", "SymFloatType",
    "BoolType", "SymBoolType", "NumberType", "ComplexType", "DeviceObjType",
    "ScalarTypeType", "LayoutType", "MemoryFormatType", "GeneratorType",
    "NoneType"))
#: the string arguments an allowed op may take: each picks a mode of its
#: op or words an error (a file name, a message to print or a string
#: operand is none of them)
_STRING_ARGS = frozenset((
    "approximate", "rounding_mode", "reduce", "equation", "indexing",
    "padding", "padding_side", "pad_mode", "side", "interpolation", "norm",
    "mode", "UPLO", "driver", "ord", "p", "activation", "assert_msg",
    "api_name"))

#: the entries of a saved program (under the archive's root directory);
#: the first three must be present
_MODEL = "models/model.json"
_WEIGHTS = "data/weights/model_weights_config.json"
_CONSTANTS = "data/constants/model_constants_config.json"
_SAMPLE_INPUTS = "data/sample_inputs/model.pt"
_PLAIN = ("archive_format", "archive_version", "byteorder", ".data/version")
_SERIAL_ID = ".data/serialization_id"
_ENTRIES = (_MODEL, _WEIGHTS, _CONSTANTS, _SAMPLE_INPUTS, *_PLAIN,
            _SERIAL_ID)

#: ``torch.export.load`` keeps its deserializer in a module global: one
#: load at a time (the proxy compiles on each client's own thread)
_load_lock = threading.Lock()


class ProgramRefused(ValueError):
    """The bytes are not a program the proxy runs."""


# --- client side ---------------------------------------------------------------

def trace_device(device) -> torch.device:
    """Where this process traces a program for a proxy on ``device``: on
    that device when this process can make its tensors, else on the CPU.
    A fake CUDA tensor needs a CUDA context for autograd's stream
    bookkeeping, so a tenant with its devices hidden (proxy attach) cannot
    trace a backward pass on ``cuda``; the proxy rewrites the devices."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        return torch.device("cpu")
    return dev


def _spec(leaf) -> tuple[tuple[int, ...], torch.dtype]:
    """``(shape, dtype)`` of a tensor, an array or anything with ``shape``
    and ``dtype`` (a remote buffer: a dtype name)."""
    dtype = leaf.dtype
    if not isinstance(dtype, torch.dtype):
        dtype = torch_dtype(getattr(dtype, "name", dtype))
    return tuple(leaf.shape), dtype


def export_program(fn, example_args, device
                   ) -> tuple[bytes, TreeDef, TreeDef, list]:
    """Trace ``fn(*example_args)`` abstractly and save it.

    ``example_args`` is a tree whose leaves have a shape and a dtype
    (tensors, numpy arrays, remote buffers); only those are read. Every
    leaf of ``fn``'s output must be a tensor. Returns ``(blob, in_def,
    out_def, out_meta)``: the saved program, the trees' structures and
    each output's ``(shape, dtype name)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves, in_def = tree_flatten(tuple(example_args))
    specs = [_spec(x) for x in leaves]
    dev = trace_device(device)
    out_defs: list = []

    def flat_fn(*flat):
        out = fn(*tree_unflatten(in_def, list(flat)))
        out_leaves, out_def = tree_flatten(out)
        for x in out_leaves:
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"a remote program returns tensors only, "
                                f"got a {type(x).__name__}")
        out_defs.append(out_def)
        return tuple(out_leaves)

    with FakeTensorMode():
        fakes = [torch.empty(shape, dtype=dtype, device=dev)
                 for shape, dtype in specs]
    graph = make_fx(flat_fn, tracing_mode="fake")(*fakes)
    ep = torch.export.export(graph, tuple(fakes), strict=False)
    ep.example_inputs = None
    for node in ep.graph.nodes:
        node.meta = {k: v for k, v in node.meta.items() if k == "val"}
    out_meta = [(list(v.shape), dtype_name(v.dtype))
                for v in _output_vals(ep.graph)]
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue(), in_def, out_defs[0], out_meta


def _output_vals(graph) -> list:
    out = next(n for n in graph.nodes if n.op == "output")
    return [a.meta["val"] for a in out.args[0]]


# --- proxy side ----------------------------------------------------------------

class Program:
    """A loaded program on one device: ``program(*tensors)`` runs it once
    and returns its outputs, a list. An output may be one of its inputs
    (an in-place update returned)."""

    def __init__(self, key: str, module, in_meta: list, out_meta: list):
        self.key = key
        self._module = module
        #: (shape tuple, torch dtype) of each argument
        self.in_meta = in_meta
        #: (shape tuple, dtype name) of each output
        self.out_meta = out_meta

    @property
    def out_nbytes(self) -> int:
        return sum(_nbytes(shape, torch_dtype(d))
                   for shape, d in self.out_meta)

    def __call__(self, *args) -> list:
        return list(self._module(*args))


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * dtype.itemsize


def _type_allowed(t, name: str) -> bool:
    kind = t.kind()
    if kind in ("OptionalType", "ListType"):
        return _type_allowed(t.getElementType(), name)
    if kind == "StringType":
        return name in _STRING_ARGS
    return kind in _VALUE_KINDS


def _schema_allowed(op: torch._ops.OpOverload) -> bool:
    """An op of an allowed namespace whose schema takes and gives values
    only (see the module docstring)."""
    schema = op._schema
    return (op.namespace in ALLOWED_NAMESPACES
            and all(_type_allowed(a.type, a.name)
                    for a in (*schema.arguments, *schema.returns)))


def _op_allowed(name: str) -> bool:
    # "torch.ops.<namespace>.<op>.<overload>", resolved among the ops
    # registered in this process
    parts = name.split(".")
    if not (len(parts) == 5 and parts[:2] == ["torch", "ops"]
            and parts[2] in ALLOWED_NAMESPACES):
        return False
    try:
        op = getattr(getattr(getattr(torch.ops, parts[2]), parts[3]),
                     parts[4])
    except (AttributeError, RuntimeError):
        return False
    return isinstance(op, torch._ops.OpOverload) and _schema_allowed(op)


def _check_json_args(value, where: str) -> None:
    """Refuse a nested graph and any operator argument outside the
    allowed namespaces, anywhere in a node's arguments."""
    if isinstance(value, dict):
        for key, sub in value.items():
            if key == "as_graph":
                raise ProgramRefused(f"{where}: nested graphs are refused")
            if key == "as_operator" and not _op_allowed(str(sub)):
                raise ProgramRefused(f"{where}: op {sub} is not allowed")
            _check_json_args(sub, where)
    elif isinstance(value, list):
        for sub in value:
            _check_json_args(sub, where)


def _check_model(model: dict) -> None:
    """The program's JSON before anything is loaded: static shapes, no
    guard code, no parameters or constants, allowed ops only."""
    if model.get("guards_code") or model.get("range_constraints"):
        raise ProgramRefused("guard code and dynamic shapes are refused")
    graph = model["graph_module"]["graph"]
    signature = model["graph_module"]["signature"]
    for spec in signature["input_specs"]:
        if set(spec) != {"user_input"}:
            raise ProgramRefused(f"inputs are tensors passed by the caller "
                                 f"only, got {sorted(spec)}")
    if graph.get("custom_obj_values"):
        raise ProgramRefused("custom objects are refused")
    for node in graph["nodes"]:
        target = str(node["target"])
        hop = target.rpartition(".")[2]
        if not (_op_allowed(target)
                or (target.startswith("torch.ops.higher_order.")
                    and hop in ALLOWED_HIGHER_ORDER)):
            raise ProgramRefused(f"op {target} is not allowed (only "
                                 f"{', '.join(ALLOWED_NAMESPACES)} ops on "
                                 f"values, and "
                                 f"{', '.join(ALLOWED_HIGHER_ORDER)})")
        _check_json_args(node["inputs"], target)


def _rewrite_devices(value, device: torch.device):
    """Every device in the JSON (an op's device argument, a tensor's
    metadata) → ``device``; also drops per-node metadata."""
    if isinstance(value, dict):
        out = {}
        for key, sub in value.items():
            if (key in ("as_device", "device") and isinstance(sub, dict)
                    and "type" in sub):
                out[key] = {"type": device.type, "index": device.index}
            elif key == "metadata" and "target" in value:
                out[key] = {}
            else:
                out[key] = _rewrite_devices(sub, device)
        return out
    if isinstance(value, list):
        return [_rewrite_devices(sub, device) for sub in value]
    return value


def canonical_archive(blob: bytes, device) -> tuple[str, bytes]:
    """Check a saved program and rewrite it as the proxy loads it: the
    schema JSON with its devices set to ``device`` and its node metadata
    dropped, no example inputs, a fixed serialization id. Returns ``(key,
    archive)``, the key being the archive's sha256. Refuses
    (:class:`ProgramRefused`) what it does not take."""
    dev = torch.device(device)
    try:
        zf = zipfile.ZipFile(io.BytesIO(bytes(blob)))
    except zipfile.BadZipFile:
        raise ProgramRefused("a program is a torch.export archive") from None
    names = zf.namelist()
    root = names[0].split("/", 1)[0] if names else ""
    entries = {}
    for name in names:
        rel = name[len(root) + 1:] if name.startswith(root + "/") else None
        if rel not in _ENTRIES:
            raise ProgramRefused(f"the archive holds {name!r}: only a "
                                 f"program's schema is loaded")
        entries[rel] = name
    if not all(e in entries for e in (_MODEL, _WEIGHTS, _CONSTANTS)):
        raise ProgramRefused("not a torch.export archive (no model)")
    for config in (_WEIGHTS, _CONSTANTS):
        if json.loads(zf.read(entries[config])) != {"config": {}}:
            raise ProgramRefused("weights and constants are refused: a "
                                 "program takes its tensors as arguments")
    model = json.loads(zf.read(entries[_MODEL]))
    _check_model(model)
    model = _rewrite_devices(model, dev)
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w", zipfile.ZIP_STORED) as w:
        def put(rel: str, data: bytes) -> None:
            info = zipfile.ZipInfo(f"archive/{rel}", (1980, 1, 1, 0, 0, 0))
            w.writestr(info, data)
        for rel in _PLAIN:
            if rel in entries:
                put(rel, zf.read(entries[rel]))
        put(_MODEL, json.dumps(model, sort_keys=True).encode())
        put(_WEIGHTS, b'{"config": {}}')
        put(_CONSTANTS, b'{"config": {}}')
        put(_SAMPLE_INPUTS, b"")
        put(_SERIAL_ID, b"0")
    archive = out.getvalue()
    return hashlib.sha256(archive).hexdigest(), archive


def _check_graph(graph) -> None:
    """The loaded graph, op by op (the JSON was checked before loading)."""
    for node in graph.nodes:
        if node.op in ("placeholder", "output"):
            continue
        if node.op != "call_function":
            raise ProgramRefused(f"{node.op} nodes are refused")
        target = node.target
        if target is operator.getitem:
            continue
        if isinstance(target, torch._ops.HigherOrderOperator):
            if target.name() in ALLOWED_HIGHER_ORDER:
                continue
        elif isinstance(target, torch._ops.OpOverload):
            if _schema_allowed(target):
                continue
        raise ProgramRefused(f"op {target} is not allowed")


def load_program(blob: bytes, device) -> Program:
    """Load a saved program to run on ``device`` (see the module
    docstring for what is refused)."""
    dev = torch.device(device)
    key, archive = canonical_archive(blob, dev)
    with _load_lock:
        ep = torch.export.load(io.BytesIO(archive))
    _check_graph(ep.graph)
    in_meta = [(tuple(v.shape), v.dtype) for v in
               (n.meta["val"] for n in ep.graph.nodes if n.op == "placeholder")]
    out_meta = [(tuple(v.shape), dtype_name(v.dtype))
                for v in _output_vals(ep.graph)]
    return Program(key, ep.module(), in_meta, out_meta)
