"""Training-stat logger (port of ``FileTrainLogger`` from
``speechbrain_tpu/utils/train_logger.py``): one summary line per epoch in
a text file."""

import logging

logger = logging.getLogger(__name__)


class FileTrainLogger:
    """One line per epoch in a text file, e.g.
    ``epoch: 3, lr: 1.00e-03 - train loss: 2.31 - valid loss: 2.40``

    Example
    -------
    >>> import os, tempfile
    >>> path = os.path.join(tempfile.mkdtemp(), "log.txt")
    >>> FileTrainLogger(path).log_stats({"epoch": 1}, {"loss": 2.5},
    ...                                 verbose=False)
    >>> open(path).read()
    'epoch: 1 - train loss: 2.50\\n'
    """

    def __init__(self, save_file, precision=2):
        self.save_file = save_file
        self.precision = precision

    def _item_to_string(self, key, value, dataset=None):
        if isinstance(value, float) and 1.0 < value < 100.0:
            value = f"{value:.{self.precision}f}"
        elif isinstance(value, float):
            value = f"{value:.{self.precision}e}"
        if dataset is not None:
            key = f"{dataset} {key}"
        return f"{key}: {value}"

    def _stats_to_string(self, stats, dataset=None):
        return ", ".join(
            self._item_to_string(k, v, dataset) for k, v in stats.items()
        )

    def log_stats(self, stats_meta, train_stats=None, valid_stats=None,
                  test_stats=None, verbose=True):
        summary = self._stats_to_string(stats_meta)
        for dataset, stats in (("train", train_stats),
                               ("valid", valid_stats),
                               ("test", test_stats)):
            if stats is not None:
                summary += " - " + self._stats_to_string(stats, dataset)
        with open(self.save_file, "a", encoding="utf-8") as fout:
            print(summary, file=fout)
        if verbose:
            logger.info(summary)
