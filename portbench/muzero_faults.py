"""The learned-model cells' control and planted faults, for the readings that
set their limits (``muzero_controls.py``) and for the tests that the check
catches each (``tests/test_portbench_muzero.py``).  No run of the benchmark
plants any.  Each is a context manager that patches the program or the
benchmark's network maker and undoes the patch when it ends:

* ``float8`` (the control): the plain reference's network with every
  convolution and dense layer in float8 e4m3 (``reference.muzero``'s
  ``fp8``), one step below the configuration's bfloat16, in the program's
  network's place;
* ``stale_latent``: ``g`` reads the root's hidden state at every expansion,
  not the parent's;
* ``no_scale``: the towers' outputs left unscaled (``scale`` only rounds).

``register()`` adds them to ``faults.py``'s ``plant``, beside the batched
search's faults that apply here (``unchanged``, ``half_batch``,
``altered``), and lists in its table of each driver's faults, which the
tests plant at a small size, those that a small size catches against the
full-size limits: the shared ones and ``no_scale``.  The control and
``stale_latent`` move the readings by less than the limits' room there and
are held to the limits at full size on the card.
"""

from __future__ import annotations

import contextlib

import torch

from portbench import faults

DRIVER = "latent_search"
OWN = ("float8", "stale_latent", "no_scale")
SHARED = ("unchanged", "half_batch", "altered")


class Float8MuZero(torch.nn.Module):
    """The reference's ``h``, ``g`` and ``f`` in float8 over the benchmark's
    weights, called as the search calls a learned model, its store of
    hidden states float32."""

    def __init__(self, weights: dict, config: dict):
        super().__init__()
        self.weights = weights
        self.shape = (config["channels"], config["board_size"], config["board_size"])
        # the weights as parameters, so the front end finds the network's device
        self.held = torch.nn.ParameterList(torch.nn.Parameter(t, requires_grad=False) for t in weights.values())

    def latent_store(self, slots, batch, device):
        return torch.empty((slots, batch) + self.shape, dtype=torch.float32, device=device)

    def represent(self, states, out):
        from portbench.reference import muzero

        return out.copy_(muzero.represent(self.weights, states, fp8=True))

    def dynamics_input(self, store, parent, actions):
        return store[parent.to(torch.int64), torch.arange(store.shape[1], device=store.device)], actions

    def dynamics_from_input(self, x, out):
        from portbench.reference import muzero

        return out.copy_(muzero.dynamics(self.weights, *x, fp8=True))

    def dynamics(self, s, actions):
        return self.dynamics_from_input((s, actions), torch.empty_like(s))

    def predict(self, s):
        from portbench.reference import muzero

        return muzero.predict(self.weights, s, fp8=True)


@contextlib.contextmanager
def plant(kind: str):
    """Plant ``kind`` (one of ``OWN``) for the learned-model cells."""
    from gymgo_tpu_torch.models import muzero_net

    if kind == "float8":
        from portbench.lib import muzero_weights

        def make(program_net):
            def control(config, seed, device):
                _, w = program_net(config, seed, device)
                return Float8MuZero(w, config), w
            return control
        with faults._patched(muzero_weights, "program_net", make):
            yield
        return
    if kind == "stale_latent":
        def make(dynamics_input):
            return lambda self, store, parent, actions: dynamics_input(self, store, torch.zeros_like(parent), actions)
        with faults._patched(muzero_net.MuZeroNet, "dynamics_input", make):
            yield
        return
    if kind == "no_scale":
        def make(_):
            def unscaled(x, out=None):
                return x.clone() if out is None else out.copy_(x)
            return unscaled
        with faults._patched(muzero_net, "scale", make):
            yield
        return
    raise ValueError(f"no fault {kind!r} for {DRIVER}")


def register() -> None:
    """Make ``faults.plant(kind, "latent_search")`` plant this module's
    faults, the shared ones as the batched search's, and list them all in
    ``faults.FAULTS``."""
    if DRIVER in faults.FAULTS:
        return
    faults.FAULTS[DRIVER] = SHARED + ("no_scale",)
    shared_plant = faults.plant

    def plant_any(kind: str, driver: str):
        if driver != DRIVER:
            return shared_plant(kind, driver)
        return plant(kind) if kind in OWN else shared_plant(kind, "batched_search")
    faults.plant = plant_any
