"""Seeded weights, made on the device in one draw, and the check that the
program's model has the layout that the reference's spec names."""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

from portbench.reference import common as C

# Mixed into the seed of the weights' generator, so that its stream is not
# that of any generator the program seeds from the same seed.
WEIGHT_SEED_MIX = 0x77656967


def make(spec: Sequence[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 leaves of ``spec`` (``reference/common.py::make_params``)
    from one uniform draw of a generator on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed ^ WEIGHT_SEED_MIX)
    flat = torch.rand(C.spec_size(spec), generator=gen, device=device)
    return C.make_params(spec, flat)


def check_layout(state: Mapping[str, torch.Tensor], spec: Sequence[tuple]
                 ) -> None:
    """Raise unless the program's state_dict has exactly ``spec``'s leaves
    and shapes: the configuration file and the program disagree."""
    want = {n: tuple(s) for n, s, _, _ in spec}
    have = {n: tuple(t.shape) for n, t in state.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))
        raise ValueError(f"the program's model differs from the "
                         f"configuration file: {diff[:8]}")
