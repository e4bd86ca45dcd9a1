"""How a kernel's output is held against its plain version.

A kernel and its plain version round at the same points, but not against
the same numbers: the kernel rounds each probability to bf16 against its
running row maximum, the plain version against the final one, and they sum
in different orders.  So on bf16 inputs their f32 outputs differ by about
2**-9 of each output, and after the output's own rounding to bf16 a good
share of the elements differ by one ulp.  A fixed absolute limit cannot
tell that from a fault.  Over a 15000-key window the outputs of unit-scale
inputs are ~0.013 in size, so an absolute 1e-2 passes a kernel that drops
a whole key group, while outputs of size 2 and more differ by more than
1e-2 at one ulp.  Two limits scaled to the reference can:

- the largest error, at most ``MAX_REL`` of the largest |reference|: one
  bf16 ulp at the largest output is at most 2**-7 of it;
- the error's root mean square, at most ``RMS_REL`` of the reference's:
  a one-ulp error on every element stays below it.  Dropping k of n keys
  of similar weight moves the output by about sqrt(k / n) in this ratio
  (0.03 for 14 of 15000 keys).
"""

from __future__ import annotations

import torch

MAX_REL = 1e-2
RMS_REL = 2.0 ** -7


def disagreement(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The distance of `out` from `ref` in the terms of the two limits,
    with `agrees` set when both hold."""
    if out.shape != ref.shape:
        raise ValueError(f"shapes differ: {tuple(out.shape)} vs "
                         f"{tuple(ref.shape)}")
    r = ref.double()
    d = out.double() - r
    err, scale = d.abs().max().item(), r.abs().max().item()
    rms_err, rms = d.square().mean().sqrt().item(), \
        r.square().mean().sqrt().item()
    return {"max_abs_err": err,
            "max_rel_err": err / scale if scale else (0.0 if err == 0
                                                      else float("inf")),
            "rms_rel_err": rms_err / rms if rms else (0.0 if rms_err == 0
                                                      else float("inf")),
            "agrees": err <= MAX_REL * scale and rms_err <= RMS_REL * rms}
