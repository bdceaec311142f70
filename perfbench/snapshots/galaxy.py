"""The ``test://N`` galaxy: ``reference.snapshot``'s seeded three-component
Gaussian mixture, made on the device, with the test-quantity under the
configuration's ``quantity`` name and no bands of its own."""

from __future__ import annotations

from perfbench import reference


def make(config, seed, device) -> dict:
    ps, mass, qty = reference.snapshot(config["n_particles"], seed, device,
                                       mass=config["particle_mass"])
    return {"pos_smooth": ps, "mass": mass,
            "quantities": {config["quantity"]: qty}}
