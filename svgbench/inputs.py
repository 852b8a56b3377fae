"""Weights and inputs made from --seed on the device, the same for the
program and the reference.

Weights: a parameter list of the model's own names (each family's
`param_spec`) with the init of each: N(0, std^2) or a constant. One
torch.Generator on the device draws every normal parameter of a group (a
block, or the parameters outside the blocks) in ONE call per dtype, in the
dtype the model serves it in, and scales the views. The reference calls the
same function with the same seed and upcasts: the same values, drawn again,
never read from the program.
"""

from __future__ import annotations

import dataclasses
import math

import torch

# sub-streams of one seed; a new input takes a new number
STREAM_WEIGHTS, STREAM_TEXT, STREAM_NOISE, STREAM_ROWS, STREAM_WARM = range(5)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one sub-stream of `seed` (any whole
    number; the sub-streams of seeds below 2**59 are all distinct)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 16 + stream) % (2**63))


@dataclasses.dataclass(frozen=True)
class Param:
    name: str
    shape: tuple
    dtype: str  # "bf16" | "f32"
    std: float | None = None  # N(0, std^2); None: the constant `value`
    value: float = 0.0
    group: str = ""

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def linear_params(prefix: str, d_in: int, d_out: int, dtype: str, group: str, bias: bool = True) -> list[Param]:
    """A linear layer at the published init: weight N(0, 1/d_in), zero bias."""
    out = [Param(f"{prefix}.weight", (d_out, d_in), dtype, std=d_in**-0.5, group=group)]
    if bias:
        out.append(Param(f"{prefix}.bias", (d_out,), dtype, value=0.0, group=group))
    return out


def make_params(spec: list[Param], seed: int, device, consume) -> None:
    """Draw every parameter of `spec` and hand it to consume(param, tensor),
    a group at a time: one randn call per (group, dtype) for its normal
    parameters. The tensors of a group are views of one buffer, dropped once
    consume has seen them."""
    gen = generator(seed, STREAM_WEIGHTS, device)
    groups: dict[str, list[Param]] = {}
    for p in spec:
        groups.setdefault(p.group, []).append(p)
    for group in groups.values():
        for dt in ("bf16", "f32"):
            normal = [p for p in group if p.dtype == dt and p.std is not None]
            if normal:
                buf = torch.randn(sum(p.numel for p in normal), generator=gen, device=device, dtype=DTYPES[dt])
                off = 0
                for p in normal:
                    consume(p, buf[off:off + p.numel].view(p.shape).mul_(p.std))
                    off += p.numel
                del buf
        for p in group:
            if p.std is None:
                consume(p, torch.full(p.shape, p.value, device=device, dtype=DTYPES[p.dtype]))


def f32_params(spec: list[Param], seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter upcast to f32 (the reference's copy)."""
    out = {}
    make_params(spec, seed, device, lambda p, t: out.__setitem__(p.name, t.float()))
    return out


def load_into(module: torch.nn.Module, spec: list[Param], seed: int) -> None:
    """Write the drawn parameters into the program's module; its parameter
    names, shapes and dtypes have to be spec's, all of them."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - {p.name for p in spec})
    extra = sorted({p.name for p in spec} - set(params))
    if missing or extra:
        raise ValueError(f"parameter spec and module differ: missing {missing[:5]}, extra {extra[:5]}")
    device = next(iter(params.values())).device

    def consume(p: Param, t: torch.Tensor):
        dst = params[p.name]
        if tuple(dst.shape) != p.shape or dst.dtype != DTYPES[p.dtype]:
            raise ValueError(f"{p.name}: module {tuple(dst.shape)} {dst.dtype}, spec {p.shape} {p.dtype}")
        with torch.no_grad():
            dst.copy_(t)

    make_params(spec, seed, device, consume)


def normal(shape, seed: int, stream: int, device):
    """Standard normal f32 input of `shape` (the noise)."""
    return torch.randn(shape, generator=generator(seed, stream, device), device=device)
