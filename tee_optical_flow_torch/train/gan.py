"""Adversarial training helpers (the JAX package's train/gan.py).

Parity with the reference's GAN utilities (finetune-SAM/utils/utils.py:
update_d :1087, gradient penalty :1113): one discriminator update with
WGAN-GP, on an ``nn.Module`` discriminator. The input gradient of the
penalty comes from ``torch.autograd.grad(create_graph=True)``, so the
penalty itself is differentiable in the discriminator's parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def gradient_penalty(disc: nn.Module, real: torch.Tensor,
                     fake: torch.Tensor, eps: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """WGAN-GP penalty: (||grad_x D(x_interp)|| - 1)^2 averaged over the
    batch. ``eps`` (B, 1, ..., 1) is the interpolation draw; by default
    uniform from ``generator``."""
    if eps is None:
        eps = torch.rand((real.shape[0],) + (1,) * (real.ndim - 1),
                         generator=generator).to(real.device)
    interp = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    grads, = torch.autograd.grad(disc(interp).sum(), interp,
                                 create_graph=True)
    norms = torch.sqrt(torch.sum(grads ** 2, dim=tuple(
        range(1, grads.ndim))) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def discriminator_loss(disc: nn.Module, real: torch.Tensor,
                       fake: torch.Tensor, eps: Optional[torch.Tensor] = None,
                       gp_weight: float = 10.0,
                       generator: Optional[torch.Generator] = None):
    """Wasserstein discriminator loss with gradient penalty (the
    reference's update_d step): (loss, (d_real, d_fake, gp))."""
    d_real = torch.mean(disc(real))
    d_fake = torch.mean(disc(fake))
    gp = gradient_penalty(disc, real, fake, eps, generator)
    return d_fake - d_real + gp_weight * gp, (d_real, d_fake, gp)


def update_d(disc: nn.Module, optimizer: torch.optim.Optimizer,
             real: torch.Tensor, fake: torch.Tensor,
             eps: Optional[torch.Tensor] = None, gp_weight: float = 10.0,
             generator: Optional[torch.Generator] = None):
    """One discriminator update: (loss, (d_real, d_fake, gp)); ``fake``
    is detached, so the generator is untouched."""
    optimizer.zero_grad(set_to_none=True)
    loss, aux = discriminator_loss(disc, real, fake.detach(), eps,
                                   gp_weight, generator)
    loss.backward()
    optimizer.step()
    return loss.detach(), tuple(a.detach() for a in aux)
