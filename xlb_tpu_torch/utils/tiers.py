"""Route notices: every choice that keeps part of a scene off a fused
kernel route (a level that stays on the TORCH tier, a gate that trips)
goes through :func:`notify_fallback`, so a run configured for the fused
routes never leaves them without a signal. None of these is a device
fallback: a CUDA tensor still runs on the card or raises."""

import logging
import warnings

logger = logging.getLogger("xlb_tpu_torch")


def notify_fallback(message):
    """One-line notice through ``warnings`` (``RuntimeWarning``,
    deduplicated per call site by the default filter) and the
    ``xlb_tpu_torch`` logger."""
    warnings.warn(message, RuntimeWarning, stacklevel=3)
    logger.warning(message)
