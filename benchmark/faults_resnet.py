"""Faults of a dual-head network's training step, planted under the timed
path to show that ``correct`` catches them (``harness.run(...,
patch="benchmark.faults_resnet:<name>")``); never called by a real run.

- ``bn_frozen``: batch normalisation left in eval mode inside the step: it
  normalises by the running statistics and never updates them;
- ``outcome_dropped``: the value head trained towards 0 whatever the game's
  outcome.
"""

from __future__ import annotations


def bn_frozen() -> None:
    import torch.nn.functional as F

    from deepgo_tpu_torch.models import resnet

    def forward(self, x):
        x = F.conv2d(x, self.weight.to(x.dtype),
                     padding=self.weight.shape[-1] // 2)
        bn = self.bn
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)

    resnet.ConvBN.forward = forward


def outcome_dropped() -> None:
    import torch

    from deepgo_tpu_torch.training import steps

    real = steps.joint_loss

    def joint_loss(logits, value, targets, z):
        return real(logits, value, targets, torch.zeros_like(z))

    steps.joint_loss = joint_loss
