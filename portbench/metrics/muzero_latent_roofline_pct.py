"""The store gather's share of its roofline: the bytes the program's spans
of it must move (counter ``search.latent_bytes``: each board's parent state
read and ``g``'s input written, from shapes, as
``muzero_counts.latent_bytes``), over the device time under
``search.latent``, over 3.35 TB/s, in %."""

from portbench.lib import counts, layers


def read(run):
    moved = layers.replayed_count(run.trace, "search.latent_bytes", "search.latent")
    s = layers.device_seconds(run.trace, "search.latent")
    if not moved or not s:
        return None
    return 100.0 * moved / s / counts.HBM_BYTES
