"""A kernel's share of its roofline, for the ``<kernel>_roofline`` readers."""


def share(run, kernel: str):
    """100 x bound / the default config's event time, or ``None`` where the
    cell runs another kernel or the card is not in the table of peaks."""
    if run.cell.config["kernel"] != kernel or not run.bound_ms or not run.default_ms:
        return None
    return 100.0 * run.bound_ms / run.default_ms
