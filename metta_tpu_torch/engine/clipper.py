"""Clipper: the global infection process over assemblers.

Counterpart of ``metta_tpu/engine/clipper.py`` (parity:
``systems/clipper.hpp:14-238``). The compiler precomputes the pairwise
infection weights (``1 << (cutoff - scaled_dist)`` within the L-infinity
cutoff, 0 otherwise, clip-immune assemblers excluded), so a step is array
math: a Bernoulli(1/clip_period) trial, then a weighted pick over the
border (unclipped assemblers with nonzero infection weight from clipped
ones), or a uniform pick over every unclipped assembler when the border is
empty.

The JAX step splits the draws from each env's key. Here they are an
explicit input, :class:`ClipDraws`, as the agent order is: the step takes
them from the caller, else :func:`clipper_draws` draws them from the
caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ClipDraws(NamedTuple):
    """One step's clipper draws for E envs."""

    trial: torch.Tensor    # [E] bool: the Bernoulli(1/clip_period) trial came up
    gumbel: torch.Tensor   # [E, NA] float32 Gumbel noise over the assembler slots
    proto: torch.Tensor    # [E] int: the unclip protocol a newly clipped slot takes


def clipper_draws(tables, E: int, generator=None, device="cpu") -> ClipDraws:
    """The clipper's draws for E envs from ``generator``: the trial
    ``randint(1, clip_period + 1) == 1``, standard Gumbel noise and a
    uniform unclip protocol, as ``clipper_step`` draws them in JAX."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((E, tables.n_assembler_slots), generator=generator, device=device)
    return ClipDraws(
        trial=torch.randint(1, tables.clip_period + 1, (E,), generator=generator,
                            device=device) == 1,
        gumbel=-torch.log(-torch.log(u.clamp(min=tiny))),
        proto=torch.randint(0, max(tables.n_unclip_protocols, 1), (E,), generator=generator,
                            device=device),
    )


def clipper_active(tables) -> bool:
    """Whether the step runs the clipper (``step.py:192`` in JAX)."""
    return bool(tables.clipper_enabled and tables.clip_period > 0)


def clipper_step(state, tables, draws: ClipDraws):
    """One clipper tick of every env with ``draws``; returns the new state."""
    NA = state.asm_clipped.shape[1]
    NT = tables.type_clip_immune.shape[0]
    t = state.asm_type.long()
    immune = ((t >= 0) & (t < NT)) & tables.type_clip_immune[t.clamp(0, NT - 1)]
    eligible = state.asm_valid & ~immune
    unclipped = eligible & ~state.asm_clipped
    dev = state.asm_clipped.device
    do = draws.trial.to(dev) & unclipped.any(1)                               # [E]

    # infection weight of each candidate: the sum over clipped sources
    src = (state.asm_clipped & eligible).to(tables.clipper_infection_w.dtype)
    w = (src[:, :, None] * tables.clipper_infection_w[None]).sum(1)            # [E, NA]
    border_w = torch.where(unclipped, w, torch.zeros_like(w))
    total = border_w.sum(1, keepdim=True)
    inf = torch.full(border_w.shape, -torch.inf, device=w.device)
    logw = torch.where(
        total > 0,
        torch.where(border_w > 0, torch.log(border_w.to(torch.float32)), inf),
        torch.where(unclipped, torch.zeros_like(inf), inf),
    )
    pick = torch.argmax(logw + draws.gumbel.to(dev), dim=1)                   # [E]

    hit = do[:, None] & (torch.arange(NA, device=w.device) == pick[:, None])
    proto = draws.proto.to(device=dev, dtype=state.asm_unclip_proto.dtype)[:, None]
    return state.replace(
        asm_clipped=state.asm_clipped | hit,
        asm_unclip_proto=torch.where(hit, proto, state.asm_unclip_proto),
        # becoming clipped resets the cooldown (assembler.hpp:411-423)
        asm_cooldown_end=torch.where(hit, state.step[:, None], state.asm_cooldown_end),
        asm_cooldown_duration=torch.where(hit, torch.zeros_like(state.asm_cooldown_duration),
                                          state.asm_cooldown_duration),
    )
