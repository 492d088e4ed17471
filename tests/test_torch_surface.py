"""The port's public surface against the JAX package's, name by name.

Every module of `anystereo_tpu/` is read with `ast` (nothing is imported, so
no JAX and no torch): its public module-level functions, classes and
ALL_CAPS constants, each public method of a public class (`__init__` and
`__call__` included), each dataclass field (a flax Module's attributes and a
`struct.PyTreeNode`'s are dataclass fields too), the names an `__init__.py`
re-exports, and the parameter names of every function and method.  The
port's module of the same path must define each name, and each function's
counterpart must take each parameter, unless `TABLE` records the pair:

  * ("renamed", target): the port's name, which must exist.  For a name,
    `target` is a dotted name in the port's module of the same path, or
    "path.py:dotted.name" in another; for a parameter, the port's parameter.
  * ("not ported", reason).

A flax Module's `__call__` is its twin's `forward`, and its fields are the
twin's constructor arguments or attributes.  The members of a renamed class
are looked up on its target.  A name the port defines under a class may be
a method, a property, a class attribute, a constructor argument or an
attribute its methods assign.  `test_surface["table"]` fails when the table
names something the JAX package no longer has, or records as not ported a
name the port now defines.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "anystereo_tpu")
PORT_ROOT = os.path.join(REPO, "anystereo_tpu_torch")

RENAMED, NOT_PORTED = "renamed", "not ported"
PARAMS = "the port's modules own their parameters: a torch module holds its weights and buffers"
MESH = "torch.distributed owns the mesh: one process a card, a process group for each axis"
REWRITE = ("a TPU schedule rewrite with the same parameters; the port accepts the ModelConfig flag "
           "and computes the plain conv form (ROADMAP ground rules)")
HEAD = "the encoder's output width is a fixed 8, the default, which no caller of the JAX package changes"
CHECK_UNUSED = ("a reference tensor the model does not take always raises, the default, which "
                "no caller of the JAX package changes")
FLAX_SETUP = "flax's lazy construction hook; a torch module builds its children in __init__"

# (module path under anystereo_tpu/, name): (kind, target or reason).
# Names: "name", "Class.member", "function(param)", "Class.method(param)",
# and "*" for a whole module.
TABLE = {
    # whole modules
    ("ops/pallas/__init__.py", "*"): (NOT_PORTED, "Pallas kernels: their CUDA twins are "
                                      "ops/kernels/*.py over csrc/*.cu (PERF.md §6 kernel table)"),
    ("ops/pallas/gather_kernel.py", "*"): (NOT_PORTED, "Pallas kernels B2, B3: ops/kernels/gather.py "
                                           "over csrc/gather_rows.cu"),
    ("ops/pallas/lookup_kernel.py", "*"): (NOT_PORTED, "Pallas kernels B1, B4-B8: ops/kernels/lookup*.py "
                                           "over csrc/lookup_*.cu"),
    ("utils/jax_cache.py", "*"): (NOT_PORTED, "XLA's compilation cache, JAX-only"),
    ("utils/ref_torch.py", "*"): (NOT_PORTED, "the JAX package's tests' loader of the reference "
                                  "snapshot, no runtime module"),
    # config
    ("config.py", "MeshConfig.data_axis"): (NOT_PORTED, "the name of a jax.sharding.Mesh axis; "
                                            "the port's RankMesh holds a process group for it"),
    ("config.py", "MeshConfig.spatial_axis"): (NOT_PORTED, "the name of a jax.sharding.Mesh axis; "
                                               "the port's RankMesh holds a process group for it"),
    # eval
    ("eval/validate.py", "Validator.__init__(params)"): (NOT_PORTED, PARAMS),
    ("eval/validate.py", "validate_dataset(params)"): (NOT_PORTED, PARAMS),
    ("eval/validate.py", "make_train_validate_fn(model)"): (RENAMED, "model_cfg"),
    # nn
    ("nn/layers.py", "set_widen_folds"): (NOT_PORTED, "switches the _Conv3x3x3Folded* rewrites, " + REWRITE),
    ("nn/layers.py", "ConvNormAct.param_dtype"): (NOT_PORTED, "the port's parameters are fp32, flax's "
                                                  "default, which no caller of the JAX package changes"),
    ("nn/layers.py", "TorchConvTranspose.features"): (RENAMED, "TorchConvTranspose.out_ch"),
    ("nn/layers.py", "TorchConvTranspose.param_dtype"): (NOT_PORTED, "the port's parameters are fp32, "
                                                         "flax's default, which no caller changes"),
    ("nn/liif.py", "StructureFeature"): (RENAMED, "structure_feature"),
    ("nn/liif.py", "StructureFeature.mode"): (NOT_PORTED, "structure_feature reads cfg.isu_mode"),
    ("nn/liif.py", "StructureFeature.win"): (NOT_PORTED, "structure_feature reads cfg.isu_window"),
    ("nn/liif.py", "StructureFeature.dilations"): (NOT_PORTED, "structure_feature reads cfg.isu_dilations"),
    ("nn/liif.py", "StructureFeature.__call__"): (NOT_PORTED, "a parameterless module is the "
                                                  "function structure_feature(x, cfg)"),
    ("nn/liif.py", "IpePositionEncoder"): (RENAMED, "SinusoidPositionEncoder"),
    ("nn/liif.py", "SpatialEncoding.learnable"): (NOT_PORTED, "the frequency matrix is a parameter, "
                                                  "the default, which no caller of the JAX package changes"),
    ("nn/liif.py", "SinusoidPositionEncoder.head"): (NOT_PORTED, HEAD),
    ("nn/liif.py", "IpePositionEncoder.head"): (NOT_PORTED, HEAD),
    ("nn/liif.py", "LearnedPositionEncoder.head"): (NOT_PORTED, HEAD),
    ("nn/liif.py", "DpbPositionEncoder.head"): (NOT_PORTED, HEAD),
    ("nn/model.py", "AnyStereo.setup"): (NOT_PORTED, FLAX_SETUP),
    ("nn/stems.py", "UnshuffleStem"): (RENAMED, "ConvStem"),
    ("nn/stems.py", "IgevStem"): (RENAMED, "ConvStem"),
    ("nn/update.py", "ConvGRU.fuse_zr"): (NOT_PORTED, "fuse_gru_gates, " + REWRITE),
    ("nn/update.py", "ConvGRU.joint_qx"): (NOT_PORTED, "joint_gru_convs, " + REWRITE),
    ("nn/update.py", "BasicMotionEncoder.fuse_branch_convs"): (NOT_PORTED, "fuse_motion_convs, " + REWRITE),
    ("nn/update.py", "DispHead.shift_matmul"): (NOT_PORTED, "fast_disp_head, " + REWRITE),
    ("nn/update.py", "BasicMultiUpdateBlock.fuse_zr"): (NOT_PORTED, "fuse_gru_gates, " + REWRITE),
    ("nn/update.py", "BasicMultiUpdateBlock.joint_qx"): (NOT_PORTED, "joint_gru_convs, " + REWRITE),
    ("nn/update.py", "BasicMultiUpdateBlock.head_shift_matmul"): (NOT_PORTED, "fast_disp_head, " + REWRITE),
    ("nn/update.py", "BasicMultiUpdateBlock.fuse_motion_convs"): (NOT_PORTED, "fuse_motion_convs, " + REWRITE),
    # ops
    ("ops/cost_volume.py", "build_gwc_volume_unrolled"): (RENAMED, "build_gwc_volume"),
    ("ops/lookup.py", "CorrPyramid.corr_levels"): (RENAMED, "CorrPyramid.corr"),
    ("ops/lookup.py", "CorrPyramid.geo_levels"): (RENAMED, "CorrPyramid.geo"),
    ("ops/lookup.py", "set_impl_override"): (NOT_PORTED, "a global switch between XLA and Pallas "
                                             "lookups; the port's wrappers take kernel= per call"),
    ("ops/lookup.py", "pyramid_lookup(impl)"): (RENAMED, "kernel"),
    ("ops/sampling.py", "set_gather_override"): (NOT_PORTED, "a global switch between XLA and Pallas "
                                                 "gathers; the port's gather dispatches on the device"),
    # parallel
    ("parallel/mesh.py", "make_mesh(devices)"): (NOT_PORTED, MESH + "; a rank's card is "
                                                 "cuda:LOCAL_RANK (rank_device)"),
    ("parallel/mesh.py", "replicated"): (NOT_PORTED, "returns a jax NamedSharding; torch has no sharding "
                                         "object: every rank holds whole tensors"),
    ("parallel/mesh.py", "batch_sharding"): (NOT_PORTED, "returns a jax NamedSharding; torch has no "
                                             "sharding object: shard_batch gives a rank its rows"),
    ("parallel/__init__.py", "replicated"): (NOT_PORTED, "see parallel/mesh.py"),
    ("parallel/__init__.py", "batch_sharding"): (NOT_PORTED, "see parallel/mesh.py"),
    ("parallel/spatial.py", "halo_exchange(axis_name)"): (RENAMED, "group"),
    ("parallel/spatial.py", "infer_spatial_sharded(params)"): (RENAMED, "params_or_state"),
    ("parallel/spatial.py", "infer_spatial_sharded(mesh)"): (RENAMED, "group"),
    ("parallel/spatial.py", "infer_spatial_sharded(spatial_axis)"): (NOT_PORTED, MESH),
    # train
    ("train/optimizer.py", "SkipNonFiniteState"): (RENAMED, "Optimizer"),
    ("train/optimizer.py", "SkipNonFiniteState.inner_state"): (NOT_PORTED, "the optimizer's own "
                                                               "attributes mu, nu and count"),
    ("train/optimizer.py", "skip_nonfinite_updates"): (RENAMED, "Optimizer.skip_nonfinite"),
    ("train/state.py", "TrainState.params"): (RENAMED, "TrainState.model"),
    ("train/state.py", "TrainState.opt_state"): (RENAMED, "TrainState.optimizer"),
    ("train/state.py", "TrainState.tx"): (RENAMED, "TrainState.optimizer"),
    ("train/state.py", "TrainState.batch_stats"): (NOT_PORTED, "the frozen BatchNorm statistics are "
                                                   "the model's buffers"),
    ("train/state.py", "TrainState.apply_gradients"): (RENAMED, "train/optimizer.py:Optimizer.step"),
    ("train/state.py", "TrainState.apply_gradients(grads)"): (NOT_PORTED, "the optimizer reads the "
                                                              "gradients from each parameter's .grad"),
    ("train/state.py", "create_train_state(params)"): (RENAMED, "model"),
    ("train/state.py", "create_train_state(tx)"): (RENAMED, "tcfg"),
    ("train/state.py", "create_train_state(batch_stats)"): (NOT_PORTED, "the frozen BatchNorm "
                                                            "statistics are the model's buffers"),
    ("train/state.py", "save_checkpoint(batch_stats)"): (NOT_PORTED, "the frozen BatchNorm statistics "
                                                         "are the model's buffers, saved with it"),
    ("train/state.py", "restore_eval_variables(variables)"): (RENAMED, "model"),
    ("train/step.py", "make_train_step(mesh)"): (NOT_PORTED, MESH + "; the step sums gradients over "
                                                 "the default group"),
    ("train/step.py", "make_train_step(mesh_cfg)"): (NOT_PORTED, MESH),
    # utils
    ("utils/profiling.py", "V5E_PEAK"): (RENAMED, "H100_PEAK"),
    ("utils/profiling.py", "count_params(params)"): (RENAMED, "model_or_tensors"),
    ("utils/torch_convert.py", "convert_raft_state_dict"): (RENAMED, "convert_state_dict"),
    ("utils/torch_convert.py", "convert_igev_state_dict"): (RENAMED, "convert_state_dict"),
    ("utils/torch_convert.py", "convert_raft_state_dict(check_unused)"): (NOT_PORTED, CHECK_UNUSED),
    ("utils/torch_convert.py", "convert_igev_state_dict(check_unused)"): (NOT_PORTED, CHECK_UNUSED),
}


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _is_flax(cls):
    return any(ast.unparse(b) in ("nn.Module", "linen.Module", "Module") for b in cls.bases)


def _has_fields(cls):
    return (_is_flax(cls) or any("dataclass" in ast.unparse(d) for d in cls.decorator_list)
            or any(ast.unparse(b) in ("struct.PyTreeNode", "NamedTuple") for b in cls.bases))


def _public(name):
    return not name.startswith("_") or name in ("__init__", "__call__")


def read_surface(path):
    """{name: kind} and {function or method: parameter names} of one
    module.  Kinds: function, class, method, field, constant, export,
    attribute (the last only of a class's own assignments)."""
    tree = ast.parse(open(path).read())
    names, params, flax = {}, {}, set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and _public(node.name):
            names[node.name] = "function"
            params[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            names[node.name] = "class"
            if _is_flax(node):
                flax.add(node.name)
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if _public(b.name):
                        names[f"{node.name}.{b.name}"] = "method"
                        params[f"{node.name}.{b.name}"] = _params(b)
                    for sub in ast.walk(b):  # self.x = ... in any method
                        for t in getattr(sub, "targets", [getattr(sub, "target", None)]):
                            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                                    and t.value.id == "self" and _public(t.attr)):
                                names.setdefault(f"{node.name}.{t.attr}", "attribute")
                elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name) and _public(b.target.id):
                    names[f"{node.name}.{b.target.id}"] = "field" if _has_fields(node) else "attribute"
                elif isinstance(b, ast.Assign):
                    for t in b.targets:
                        if isinstance(t, ast.Name) and _public(t.id):
                            names.setdefault(f"{node.name}.{t.id}", "attribute")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(t, ast.Name) and _public(t.id) and t.id.isupper():
                    names[t.id] = "constant"
        elif isinstance(node, ast.ImportFrom) and path.endswith("__init__.py"):
            for a in node.names:
                names[a.asname or a.name] = "export"
    return names, params, flax


def jax_modules():
    out = []
    for root, _, files in os.walk(JAX_ROOT):
        out += [os.path.relpath(os.path.join(root, f), JAX_ROOT) for f in files if f.endswith(".py")]
    return sorted(out)


_PORT_CACHE = {}


def port_surface(rel):
    if rel not in _PORT_CACHE:
        path = os.path.join(PORT_ROOT, rel)
        _PORT_CACHE[rel] = read_surface(path) if os.path.exists(path) else None
    return _PORT_CACHE[rel]


def _has(names, params, dotted):
    """Whether the port's module defines `dotted`: a name, or a class member
    in any of the forms the module docstring lists."""
    if dotted in names:
        return True
    cls, _, member = dotted.partition(".")
    return bool(member) and names.get(cls) == "class" and member in params.get(f"{cls}.__init__", ())


def _resolve(rel, target):
    """(module path, dotted name) of a rename target."""
    if ":" in target:
        other, name = target.split(":")
        return other, name
    return rel, target


def module_gaps(rel):
    """The JAX module's names and parameters the port neither defines nor
    records in `TABLE`, and the table's rename targets that do not exist."""
    if (rel, "*") in TABLE:
        return []
    names, params, flax = read_surface(os.path.join(JAX_ROOT, rel))
    names = {k: v for k, v in names.items() if v != "attribute"}
    port = port_surface(rel)
    if port is None:
        return [f"{rel}: no module in the port and no entry"]
    gaps = []

    def find(name):
        """(module, port name, found) for a JAX name: its table entry, a
        flax __call__ as forward, a member of a renamed class on the target."""
        entry = TABLE.get((rel, name))
        if entry is not None:
            if entry[0] == NOT_PORTED:
                return None, None, True
            mod, target = _resolve(rel, entry[1])
            surf = port_surface(mod)
            ok = surf is not None and _has(surf[0], surf[1], target)
            if not ok:
                gaps.append(f"{rel}: {name} renamed to {entry[1]}, which the port does not define")
            return mod, target, True
        cls, _, member = name.partition(".")
        if member:
            cmod, ccls, _ = find(cls) if (rel, cls) in TABLE else (rel, cls, True)
            if cmod is None:  # the whole class is not ported
                return None, None, True
            if member == "__call__" and cls in flax:
                member = "forward"
            surf = port_surface(cmod)
            return cmod, f"{ccls}.{member}", _has(surf[0], surf[1], f"{ccls}.{member}")
        return rel, name, _has(port[0], port[1], name)

    for name in names:
        mod, target, found = find(name)
        if not found:
            gaps.append(f"{rel}: {names[name]} {name} has no counterpart and no entry")
        if mod is None or name not in params or not found:
            continue
        theirs = port_surface(mod)[1].get(target)
        if theirs is None:  # renamed to a class or an attribute: no signature to hold
            continue
        for p in params[name]:
            entry = TABLE.get((rel, f"{name}({p})"))
            if entry is None:
                if p not in theirs:
                    gaps.append(f"{rel}: {name}({p}) is not a parameter of the port's {target} "
                                f"{theirs} and has no entry")
            elif entry[0] == RENAMED and entry[1] not in theirs:
                gaps.append(f"{rel}: {name}({p}) renamed to {entry[1]}, not a parameter of {target}")
    return gaps


def table_rot():
    """Entries that name what the JAX package no longer has, or record as
    not ported what the port now defines under the same name."""
    rot = []
    for (rel, key), (kind, _) in TABLE.items():
        path = os.path.join(JAX_ROOT, rel)
        if not os.path.exists(path):
            rot.append(f"{rel}: no such module in the JAX package")
            continue
        if key == "*":
            if kind == NOT_PORTED and port_surface(rel) is not None:
                rot.append(f"{rel}: recorded as not ported, but the port has the module")
            continue
        names, params, _ = read_surface(path)
        name, _, p = key.partition("(")
        p = p.rstrip(")")
        if name not in names:
            rot.append(f"{rel}: {name} is not in the JAX package")
        elif p and p not in params.get(name, ()):
            rot.append(f"{rel}: {name} takes no parameter {p} in the JAX package")
        elif kind == NOT_PORTED:
            port = port_surface(rel)
            if port is not None and (port[1].get(name) is not None and p in port[1][name]
                                     or not p and _has(port[0], port[1], name)):
                rot.append(f"{rel}: {key} is recorded as not ported, but the port defines it")
    return rot


@pytest.mark.parametrize("case", jax_modules() + ["table"])
def test_surface(case):
    gaps = table_rot() if case == "table" else module_gaps(case)
    assert not gaps, "\n".join(gaps)
