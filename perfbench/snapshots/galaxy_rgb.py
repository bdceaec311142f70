"""The ``test://N`` galaxy with stellar bands: ``reference.snapshot``'s
seeded three-component Gaussian mixture, made on the device, with upstream
``TestDataLoader.get_rgb_masses``'s (I, V, U) band masses ``|sin(x / 10)|``,
``|cos(y / 10)|``, ``|cos(z / 10)|`` of the positions in kpc, computed here
on the device, and no quantity."""

from __future__ import annotations

import torch

from perfbench import reference


def make(config, seed, device) -> dict:
    ps, mass, _ = reference.snapshot(config["n_particles"], seed, device,
                                     mass=config["particle_mass"])
    rgb = torch.stack([torch.abs(torch.sin(ps[:, 0] / 10.0)),
                       torch.abs(torch.cos(ps[:, 1] / 10.0)),
                       torch.abs(torch.cos(ps[:, 2] / 10.0))], dim=1)
    return {"pos_smooth": ps, "mass": mass, "quantities": {}, "rgb": rgb}
