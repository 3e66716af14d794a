"""Seeded weights in the port's parameter layout, made on the device.

The benchmark makes the weights it hands the program, and the plain
reference makes them again after the window, from the same seed, one layer
at a time. Each layer (and each top-level leaf) draws its numbers from a
``torch.Generator`` of its own, seeded from ``(seed, tag)``, in one
``randn`` call, so a layer can be made again without the others and without
a second whole copy of the model.

A family module (``reference/<family>.py``) describes layer ``i`` of a
configuration: ``layer_leaves(c, i)`` gives layer ``i``'s leaves and
``block(w, x, c, product, i)`` applies it. Layers may differ from one
another, as long as the layers the port stacks together (every ``P``-th,
``P`` the length of the family's ``attn_pattern``) have the same leaves;
:func:`layer_kinds` names each layer's kind from that pattern. A leaf is
``(path, shape, dtype, init)``: ``path`` the keys inside one layer's dict of
the port's tree, ``shape`` one layer's shape (the port stacks the layers of
one pattern position along a leading axis), ``dtype`` ``"bfloat16"`` or
``"float32"`` and ``init`` one of

* ``("he", fan_in)``: normal / sqrt(fan_in);
* ``("normal", mean, std)``;
* ``("a_log",)``: Mamba's S4D-real ``log(1..n)`` on the last axis, no draw;
* ``("dt_bias", lo, hi)``: softplus^-1 of a log-uniform step in [lo, hi]
  (the uniform taken through the normal's CDF of the layer's draw).
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, tuple]


def entropy(seed: int, *tags) -> int:
    """A 63-bit generator seed from ``seed`` (any whole number) and tags."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _numel(shape: Sequence[int]) -> int:
    return math.prod(shape)


def _draws(init: tuple) -> bool:
    return init[0] != "a_log"


def _value(init: tuple, z: torch.Tensor, shape, device) -> torch.Tensor:
    kind = init[0]
    if kind == "he":
        return z / math.sqrt(init[1])
    if kind == "normal":
        return z * init[2] + init[1]
    if kind == "a_log":
        n = shape[-1]
        return torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=device)).expand(*shape).clone()
    if kind == "dt_bias":
        lo, hi = init[1], init[2]
        u = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
        dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {init!r}")


def draw(leaves: Iterable[Leaf], seed: int, tag: tuple, device,
         served: bool = True) -> Dict[Tuple[str, ...], torch.Tensor]:
    """One group's leaves (a layer, or one top-level leaf) from one draw:
    in their served dtypes, or with ``served=False`` those values in fp32."""
    leaves = list(leaves)
    n = sum(_numel(s) for _, s, _, init in leaves if _draws(init))
    gen = torch.Generator(device=device).manual_seed(entropy(seed, *tag))
    z = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    out, off = {}, 0
    for path, shape, dtype, init in leaves:
        part = None
        if _draws(init):
            part = z[off: off + _numel(shape)].view(shape)
            off += _numel(shape)
        v = _value(init, part, shape, device).to(DTYPES[dtype])
        out[path] = v if served else v.float()
    return out


def top_leaves(c: dict) -> List[Tuple[str, Leaf]]:
    """The leaves outside the layers, each its own draw: the token table, the
    output head (untied) and the final norm, as ``(tag, leaf)``."""
    d, vp = c["hidden_size"], padded_vocab(c)
    return [("tok", (("embed", "tok"), (vp, d), c["torch_dtype"], ("he", d))),
            ("head", (("embed", "head"), (d, vp), c["torch_dtype"], ("he", d))),
            ("final_norm", (("final_norm", "scale"), (d,), c["torch_dtype"],
                            ("normal", 0.0, 0.1)))]


def padded_vocab(c: dict, multiple: int = 512) -> int:
    """The vocabulary rounded up as the port pads it (rows no token uses)."""
    v = c["vocab_size"]
    return -(-v // multiple) * multiple


def top(c: dict, seed: int, name: str, device, served: bool = True) -> torch.Tensor:
    """One top-level leaf (``tok``, ``head`` or ``final_norm``)."""
    (tag, leaf), = [t for t in top_leaves(c) if t[0] == name]
    return draw([leaf], seed, ("top", tag), device, served)[leaf[0]]


def layer(family, c: dict, seed: int, index: int, device,
          served: bool = True) -> Dict[Tuple[str, ...], torch.Tensor]:
    """Layer ``index``'s leaves."""
    return draw(family.layer_leaves(c, index), seed, ("layer", index), device, served)


def _nest(flat: Dict[Tuple[str, ...], torch.Tensor]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return out


def layer_kinds(family, c: dict) -> List[str]:
    """Every layer's kind, in order: the family's ``attn_pattern``, cycled,
    as the port assigns the pattern units' and the remainder layers' types."""
    pattern = family.port_arch(c)["attn_pattern"]
    return [pattern[i % len(pattern)] for i in range(c["num_hidden_layers"])]


def slot(family, c: dict, index: int) -> Tuple[Tuple[Any, ...], Optional[int]]:
    """Where layer ``index`` sits in the port's tree, as
    ``transformer.init_params`` lays it out: the keys of its dict and its row
    along the stacking axis. With ``P`` the pattern's length and ``U`` the
    whole pattern units, ``("unit", j), u`` holds layer ``u * P + j``;
    ``("rem", r), None`` holds the remainder layer ``U * P + r``, unstacked."""
    p = len(family.port_arch(c)["attn_pattern"])
    units = c["num_hidden_layers"] // p
    if index < units * p:
        return ("unit", index % p), index // p
    return ("rem", index - units * p), None


def leaf_at(tree: dict, family, c: dict, index: int, path: Tuple[str, ...]) -> torch.Tensor:
    """Layer ``index``'s leaf ``path`` in the port's tree ``tree``."""
    keys, row = slot(family, c, index)
    node = tree
    for key in keys + tuple(path):
        node = node[key]
    return node if row is None else node[row]


def make_params(family, c: dict, seed: int, device) -> dict:
    """The whole parameter tree as the port lays it out: ``embed``,
    ``final_norm``, ``unit`` (one dict a pattern position, whose leaves stack
    that position's layers) and ``rem`` (the remainder layers, unstacked);
    see :func:`slot`."""
    n_layers = c["num_hidden_layers"]
    p = len(family.port_arch(c)["attn_pattern"])
    units = n_layers // p
    shapes = [[leaf[:3] for leaf in family.layer_leaves(c, j)] for j in range(p)]
    stacked = [{path: torch.empty((units, *shape), dtype=DTYPES[dtype], device=device)
                for path, shape, dtype in shapes[j]} for j in range(p)]
    rem = []
    for i in range(n_layers):
        made = layer(family, c, seed, i, device)
        (_, j), row = slot(family, c, i)
        if row is None:
            rem.append(_nest(made))
            continue
        if [leaf[:3] for leaf in family.layer_leaves(c, i)] != shapes[j]:
            raise ValueError(f"layer {i}'s leaves differ from layer {j}'s, "
                             "which the port stacks them with")
        for path, v in made.items():
            stacked[j][path][row].copy_(v)
    tree = _nest({leaf[0]: top(c, seed, tag, device) for tag, leaf in top_leaves(c)})
    tree["unit"] = tuple(_nest(s) for s in stacked)
    tree["rem"] = tuple(rem)
    return tree
