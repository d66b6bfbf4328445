"""Checkpoints: policy bundles and the trainer's state.

Counterpart of ``metta_tpu/rl/checkpoint.py``. Two artifacts per run under
``<data_dir>/<run>/checkpoints/`` (``CheckpointManager``):

1. the policy bundle ``<run>:v<epoch>/`` = ``weights.safetensors`` +
   ``policy_spec.json`` (``load_policy_bundle`` :82, ``save_policy_bundle``
   :47). A bundle holds the flax parameter tree under flat ``params/...``
   names and the architecture spec; the port converts the tree to its
   ``state_dict`` (``convert.py``) on load and back on save, so a bundle the
   port writes loads in the JAX package and the other way round;
2. the trainer state, ``torch_trainer_state.safetensors`` + its meta
   ``torch_trainer_meta.json`` (``save_trainer_state`` :137,
   ``load_trainer_state`` :157): every leaf of a ``TrainState`` under its
   path, with the states of the torch generators that the JAX package keeps
   in ``TrainState.key``. Its own names: the JAX package's
   ``trainer_state.bin`` holds another optimizer and another generator, and
   a directory that holds only that is refused by name.

The safetensors format is read and written here by hand, so that the port
needs no ``safetensors`` package: an 8-byte little-endian header
length, a JSON header ``{name: {"dtype", "shape", "data_offsets"}}`` (and an
optional ``__metadata__``), then the raw little-endian data.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import struct
from pathlib import Path
from typing import Optional

import torch

from metta_tpu_torch.convert import flax_to_state_dict, flatten_tree, state_dict_to_flax
from metta_tpu_torch.models.vit import ViTConfig

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
# the JAX package's class path, written into bundles so that it can load them
_JAX_CLASS_PATH = "metta_tpu.models.vit.ViTConfig"

logger = logging.getLogger(__name__)


def read_safetensors(path) -> dict:
    """{name: CPU tensor} from a ``.safetensors`` file."""
    data = Path(path).read_bytes()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * torch.empty((), dtype=dtype).element_size() \
                or end > len(body):
            raise ValueError(f"{path}: tensor {name} has inconsistent offsets {begin}, {end}")
        buf = bytearray(body[begin:end])
        t = torch.frombuffer(buf, dtype=dtype) if count else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape).clone()
    return out


def write_safetensors(tensors: dict, path) -> None:
    """Write {name: tensor} as a ``.safetensors`` file (little-endian data,
    header padded with spaces to a multiple of 8 bytes)."""
    header, chunks, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)))
        f.write(h)
        for c in chunks:
            f.write(c)


def load_policy_bundle(path):
    """-> (state_dict, ViTConfig, spec dict) of the bundle directory ``path``
    (a ``file://`` URI or a path)."""
    path = Path(str(path).removeprefix("file://"))
    spec = json.loads((path / "policy_spec.json").read_text())
    if spec["class_path"].rpartition(".")[2] != "ViTConfig":
        raise NotImplementedError(f"policy {spec['class_path']} is not ported")
    cfg = ViTConfig(**spec["architecture_spec"])
    flat = {k: v.numpy() for k, v in read_safetensors(path / "weights.safetensors").items()}
    return flax_to_state_dict(flat), cfg, spec


def save_policy_bundle(path, state_dict: dict, policy_cfg: ViTConfig, extra=None) -> None:
    """Write a bundle the JAX package's ``load_policy_bundle`` reads, staged
    in a sibling directory and renamed into place."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = flatten_tree(state_dict_to_flax(state_dict, policy_cfg.core_num_heads))
    write_safetensors({k: torch.from_numpy(v) for k, v in flat.items()},
                      tmp / "weights.safetensors")
    spec = {"class_path": _JAX_CLASS_PATH,
            "architecture_spec": dataclasses.asdict(policy_cfg), **(extra or {})}
    (tmp / "policy_spec.json").write_text(json.dumps(spec, indent=2))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# trainer state: a tree of tensors flattened by path
# ---------------------------------------------------------------------------

STATE_FILE = "torch_trainer_state.safetensors"
META_FILE = "torch_trainer_meta.json"
JAX_STATE_FILE = "trainer_state.bin"          # the JAX package's, refused by name
_GEN = "generator/"                            # prefix of the generator states
_EPOCH = "meta/epoch"                          # the epoch, in the state as in the meta


def flatten_state(tree, prefix: str = "") -> dict:
    """{path: tensor} of a state tree: tensors, dicts, tuples, dataclasses,
    and Python ints (as 0-d int64 tensors), paths joined by ``/`` (as
    ``flax.traverse_util.flatten_dict``)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, int) and not isinstance(tree, bool):
        return {prefix: torch.tensor(tree, dtype=torch.int64)}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = enumerate(tree)
    elif dataclasses.is_dataclass(tree):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    else:
        raise TypeError(f"state leaf {prefix!r} is a {type(tree).__name__}")
    out = {}
    for k, v in items:
        out.update(flatten_state(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_state(like, flat: dict, prefix: str = ""):
    """The tree of ``like`` with each leaf taken from ``flat`` (a ``/`` path
    each), on the like leaf's device; a shape or dtype other than the like
    leaf's raises ``ValueError`` (``flax.serialization.from_bytes`` against
    a target)."""
    if isinstance(like, (torch.Tensor, int)):
        t = flat[prefix]
        want = like if isinstance(like, torch.Tensor) else torch.tensor(like)
        if t.dtype != want.dtype or t.shape != want.shape:
            raise ValueError(f"leaf {prefix!r}: saved {t.dtype} {tuple(t.shape)}, expected "
                             f"{want.dtype} {tuple(want.shape)}")
        return t.to(like.device) if isinstance(like, torch.Tensor) else int(t)

    def sub(k, v):
        return unflatten_state(v, flat, f"{prefix}/{k}" if prefix else str(k))
    if isinstance(like, dict):
        return {k: sub(k, v) for k, v in like.items()}
    if isinstance(like, tuple):
        return tuple(sub(i, v) for i, v in enumerate(like))
    return dataclasses.replace(like, **{f.name: sub(f.name, getattr(like, f.name))
                                        for f in dataclasses.fields(like)})


class CheckpointManager:
    """Run-directory checkpoint layout + save/load/latest resolution
    (``metta_tpu/rl/checkpoint.py:93``)."""

    def __init__(self, run: str, data_dir="./train_dir"):
        self.run = run
        self.run_dir = Path(data_dir) / run
        self.checkpoint_dir = self.run_dir / "checkpoints"
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)

    # ---- policy bundles ----

    def bundle_path(self, epoch: int) -> Path:
        return self.checkpoint_dir / f"{self.run}:v{epoch}"

    def save_policy(self, state_dict: dict, policy_cfg: ViTConfig, epoch: int,
                    metadata: Optional[dict] = None) -> str:
        path = self.bundle_path(epoch)
        save_policy_bundle(path, state_dict, policy_cfg,
                           extra={"epoch": epoch, **(metadata or {})})
        return f"file://{path}"

    def list_policies(self) -> list:
        out = []
        for p in self.checkpoint_dir.glob(f"{self.run}:v*"):
            m = re.match(rf"{re.escape(self.run)}:v(\d+)$", p.name)
            if m and (p / "weights.safetensors").exists():
                out.append((int(m.group(1)), p))
        return sorted(out)

    def latest_policy_uri(self) -> Optional[str]:
        bundles = self.list_policies()
        return f"file://{bundles[-1][1]}" if bundles else None

    def load_policy(self, epoch: Optional[int] = None):
        """-> (state_dict, ViTConfig, spec dict) of the bundle of ``epoch``
        (default the latest)."""
        bundles = self.list_policies()
        if not bundles:
            raise FileNotFoundError(f"No policy bundles in {self.checkpoint_dir}")
        path = bundles[-1][1] if epoch is None else dict(bundles)[epoch]
        return load_policy_bundle(path)

    # ---- trainer state ----

    def save_trainer_state(self, ts, epoch: int, extras: Optional[dict] = None,
                           generators: Optional[dict] = None) -> None:
        """Write every leaf of ``ts`` and the state of each generator
        ({name: ``torch.Generator``}), with ``epoch`` and ``extras`` in the
        meta. Atomic: state first, meta last, each through a temporary file
        and ``os.replace``, so a kill mid-write never leaves a truncated file
        for the next resume. The state holds its epoch too: a kill between
        the two renames leaves the new state beside the previous meta, and
        ``load_trainer_state`` finds them apart."""
        flat = {k: v.detach().cpu() for k, v in flatten_state(ts).items()}
        flat[_EPOCH] = torch.tensor(epoch, dtype=torch.int64)
        for name, gen in (generators or {}).items():
            flat[_GEN + name] = gen.get_state()
        tmp = self.checkpoint_dir / (STATE_FILE + ".tmp")
        write_safetensors(flat, tmp)
        os.replace(tmp, self.checkpoint_dir / STATE_FILE)
        tmp = self.checkpoint_dir / (META_FILE + ".tmp")
        tmp.write_text(json.dumps({"epoch": epoch, "extras": extras or {}}))
        os.replace(tmp, self.checkpoint_dir / META_FILE)

    def load_trainer_state(self, ts_like, generators: Optional[dict] = None):
        """-> (state, meta) restored against ``ts_like``, each leaf on the
        like leaf's device with its dtype checked, each generator of
        ``generators`` set to its saved state; (None, None) where nothing
        was saved, or where the state is unreadable or of another epoch than
        the meta (logged: training starts fresh, as in the JAX package). Raises ``RuntimeError`` for a
        directory that holds only the JAX package's trainer state."""
        state_path = self.checkpoint_dir / STATE_FILE
        if not state_path.exists():
            if (self.checkpoint_dir / JAX_STATE_FILE).exists():
                raise RuntimeError(
                    f"{self.checkpoint_dir / JAX_STATE_FILE} is the JAX package's trainer "
                    f"state (its optimizer and PRNG key are not the port's), and there is "
                    f"no {STATE_FILE}: start from a policy bundle in a fresh run")
            return None, None
        try:
            meta = json.loads((self.checkpoint_dir / META_FILE).read_text())
            if not isinstance(meta, dict) or not isinstance(meta.get("epoch"), int):
                raise ValueError(f"{META_FILE} holds no epoch")
            flat = read_safetensors(state_path)
            epoch = flat.pop(_EPOCH, None)
            if epoch is None or int(epoch) != meta["epoch"]:
                saved = None if epoch is None else int(epoch)
                raise ValueError(f"the state is of epoch {saved}, the meta of {meta['epoch']}: "
                                 f"a save cut between its two renames")
            names = {k for k in flat if not k.startswith(_GEN)}
            if names != set(flatten_state(ts_like)):
                raise ValueError(f"saved leaves {sorted(names ^ set(flatten_state(ts_like)))} "
                                 f"do not match the trainer's")
            ts = unflatten_state(ts_like, flat)
            gen_states = {}
            for name, gen in (generators or {}).items():
                saved = flat.get(_GEN + name)
                if saved is None or saved.shape != gen.get_state().shape:
                    raise ValueError(f"no state of the {name!r} generator that fits")
                gen_states[name] = saved
        except (OSError, ValueError, KeyError, TypeError) as e:   # corrupt or truncated
            logger.warning("trainer state in %s is unreadable (%s); starting fresh",
                           self.checkpoint_dir, e)
            return None, None
        for name, state in gen_states.items():
            generators[name].set_state(state)
        return ts, meta


def resolve_uri(uri: str) -> Path:
    """file:// URIs resolve locally; other schemes raise
    (``metta_tpu/rl/checkpoint.py:177``)."""
    if uri.startswith("file://"):
        return Path(uri[7:])
    if "://" not in uri:
        return Path(uri)
    raise ValueError(f"Unsupported checkpoint URI scheme for {uri!r}; use file:// paths")
