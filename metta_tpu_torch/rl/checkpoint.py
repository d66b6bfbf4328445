"""Policy bundles: ``weights.safetensors`` + ``policy_spec.json``.

Counterpart of ``metta_tpu/rl/checkpoint.py`` (``load_policy_bundle`` :82,
``save_policy_bundle`` :47). A bundle holds the flax parameter tree under
flat ``params/...`` names and the architecture spec; the port converts the
tree to its ``state_dict`` (``convert.py``) on load and back on save, so a
bundle the port writes loads in the JAX package and the other way round.

The safetensors format is read and written here by hand, so that the port
needs no ``safetensors`` package: an 8-byte little-endian header
length, a JSON header ``{name: {"dtype", "shape", "data_offsets"}}`` (and an
optional ``__metadata__``), then the raw little-endian data.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
from pathlib import Path

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
