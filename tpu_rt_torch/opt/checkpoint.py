"""Checkpoint / resume for optimization loops.

Counterpart of ``tpu_rt/opt/checkpoint.py``, in the port's own format:
``torch.save`` of the parameters, the optimizer's ``state_dict``, the
losses and the iteration.  tpu_rt's file pickles JAX tree definitions,
which a host without JAX cannot unpickle, so the port does not read it;
``adam_state_from_arrays`` carries optax's Adam state across instead, so a
loop started in tpu_rt goes on in the port.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_checkpoint(path, params, opt_state, losses, iteration):
    """Atomic save of the optimization state: written to ``path + ".tmp"``,
    then moved over ``path``.  ``params`` is a dict of tensors,
    ``opt_state`` an optimizer's ``state_dict``."""
    tmp = path + ".tmp"
    torch.save({"params": {k: v.detach().cpu() for k, v in params.items()},
                "opt": opt_state, "losses": list(losses), "iteration": int(iteration)}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path):
    """Returns (params, opt_state, losses, iteration), or None where no
    checkpoint exists."""
    if not os.path.exists(path):
        return None
    d = torch.load(path, weights_only=False)
    return d["params"], d["opt"], d["losses"], d["iteration"]


def adam_state_from_arrays(params, mu, nu, count, lr=2e-2):
    """A ``torch.optim.Adam`` ``state_dict`` holding optax's Adam state:
    ``params``, ``mu`` and ``nu`` are dicts of numpy arrays under the same
    keys (optax's ``ScaleByAdamState.mu`` / ``.nu`` of a parameter dict),
    ``count`` its step count.  ``optimize`` resumes from a checkpoint that
    holds it (``save_checkpoint(path, params, adam_state_from_arrays(...),
    losses, count)``), as from one of its own."""
    leaves = [torch.tensor(np.asarray(params[k], np.float32)) for k in params]
    opt = torch.optim.Adam(leaves, lr=lr)
    sd = opt.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(count)),
                       "exp_avg": torch.tensor(np.asarray(mu[k], np.float32)),
                       "exp_avg_sq": torch.tensor(np.asarray(nu[k], np.float32))}
                   for i, k in enumerate(params)}
    return sd
