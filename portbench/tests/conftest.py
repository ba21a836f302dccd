"""The learned-model cells' faults join ``faults.py``'s table
(``muzero_faults.register``) before the tests that plant every fault of
every cell are collected, and their driver gets a size a test run holds."""

from portbench import muzero_faults

muzero_faults.register()

SMALL_LATENT = {"batch": 6, "root_steps": [8, 8], "simulations": 6, "considered": 4, "sampled_games": 6,
                "net_roots": 6}


def pytest_collection_modifyitems(items):
    for item in items:
        small = getattr(getattr(item, "module", None), "SMALL", None)
        if isinstance(small, dict):
            small.setdefault(muzero_faults.DRIVER, SMALL_LATENT)
