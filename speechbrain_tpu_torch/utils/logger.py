"""Rank-aware logging (port of ``speechbrain_tpu/utils/logger.py``):
``get_logger``, ``MultiProcessLoggerAdapter`` with ``warning_once``,
``setup_logging``, ``format_order_of_magnitude`` and
``get_environment_description``. The rank is ``torch.distributed``'s
where a process group is up, else the ``RANK`` environment variable, else
0; on one process everything logs.
"""

import logging
import logging.config
import math
import os
import sys

ORDERS_ABBREV = {
    -24: "y", -21: "z", -18: "a", -15: "f", -12: "p", -9: "n", -6: "µ",
    -3: "m", 0: "", 3: "k", 6: "M", 9: "G", 12: "T", 15: "P", 18: "E",
    21: "Z", 24: "Y",
}

_warned_once = set()


def _process_index():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


class MultiProcessLoggerAdapter(logging.LoggerAdapter):
    """Logs on the main process only, unless ``main_process_only=False``."""

    def log(self, level, msg, *args, main_process_only=True, **kwargs):
        if self.isEnabledFor(level):
            if main_process_only and _process_index() != 0:
                return
            msg, kwargs = self.process(str(msg), kwargs)
            self.logger.log(level, msg, *args, **kwargs)

    def warning_once(self, msg, *args, **kwargs):
        """A warning the first time this exact message is seen only."""
        if msg not in _warned_once:
            _warned_once.add(msg)
            self.warning(msg, *args, **kwargs)


def get_logger(name):
    """A rank-aware logger adapter for ``name``."""
    return MultiProcessLoggerAdapter(logging.getLogger(name), {})


def setup_logging(config=None, overrides=None, default_level=logging.INFO):
    """Configure logging from a ``dictConfig`` dict (``overrides`` merged
    into it), or to standard output at ``default_level``."""
    if config is not None:
        if overrides:
            _recursive_update(config, overrides)
        logging.config.dictConfig(config)
    else:
        logging.basicConfig(
            level=default_level,
            format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
            stream=sys.stdout,
        )


def _recursive_update(d, u):
    for k, v in u.items():
        if isinstance(v, dict) and isinstance(d.get(k), dict):
            _recursive_update(d[k], v)
        else:
            d[k] = v


def format_order_of_magnitude(number, abbreviate=True):
    """A number with an SI prefix.

    Example
    -------
    >>> format_order_of_magnitude(1300000)
    ('1.3', 'M')
    """
    order = (3 * math.floor(math.log(math.fabs(number), 1000))
             if number != 0 else 0)
    order = max(min(order, max(ORDERS_ABBREV)), min(ORDERS_ABBREV))
    num_str = "{num:3.1f}".format(num=number / 10 ** order).strip()
    return num_str, ORDERS_ABBREV[order]


def get_environment_description():
    """Python, platform, torch, CUDA and the visible devices, for
    ``env.log``."""
    import platform

    import torch

    lines = [f"Python: {sys.version}", f"Platform: {platform.platform()}",
             f"torch: {torch.__version__}", f"CUDA: {torch.version.cuda}"]
    if torch.cuda.is_available():
        lines.append("devices: " + str([
            torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())
        ]))
    else:
        lines.append("devices: ['cpu']")
    return "\n".join(lines) + "\n"
