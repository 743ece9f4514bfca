"""RANSAC hypothesis sampling shared by `tracking/reloc.pnp_ransac` and
`mapping/sim3.sim3_ransac`.

The reference draws each hypothesis' sample with
`jax.random.choice(PRNGKey(seed), N, (H, S), p=valid / sum(valid))`
(`orbslam3lib_tpu/mapping/sim3.py:59-62`, `tracking/reloc.py:67-71`); those
bits cannot be reproduced here. The port draws by inverse CDF instead:
uniforms from a `torch.Generator` on the data's device seeded with the same
`seed`, looked up in the cumulative validity weights. Only valid entries
are drawn (with replacement, as `jax.random.choice`); with none valid every
draw is 0, where `torch.multinomial` would raise. Nothing is read back to
the host. Tests pass the reference's own draws in as `hyp_idx`.
"""
from __future__ import annotations

import torch


def ransac_indices(valid: torch.Tensor, n_hyp: int, sample_size: int,
                   seed: int = 0, hyp_idx=None) -> torch.Tensor:
    """(n_hyp, sample_size) int64 indices into `valid` (N,), each drawn with
    probability valid / sum(valid); `hyp_idx`, when given, is returned as
    they are (on `valid`'s device)."""
    dev = valid.device
    if hyp_idx is not None:
        return torch.as_tensor(hyp_idx, device=dev).long()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    cdf = torch.cumsum(valid.to(torch.float32), 0)
    u = torch.rand((n_hyp, sample_size), generator=gen, device=dev)
    # right=True: an invalid entry adds nothing to the CDF, so no uniform
    # lands on it
    idx = torch.searchsorted(cdf, (u * cdf[-1]).reshape(-1), right=True)
    return torch.clamp(idx, max=valid.shape[0] - 1).reshape(n_hyp, sample_size)
