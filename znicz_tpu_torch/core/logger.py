"""Logger mixin — every component logs with its own name prefix.

Counterpart of ``znicz_tpu/core/logger.py``.
"""

import logging

_configured = False


def setup_logging(level=logging.INFO):
    global _configured
    if _configured:
        return
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
        datefmt="%H:%M:%S")
    _configured = True


class Logger(object):
    """Mixin giving self.debug/info/warning/error with class-name
    prefixes."""

    def __init__(self, logger_name=None):
        super().__init__()
        setup_logging()
        self.logger = logging.getLogger(logger_name or type(self).__name__)

    def debug(self, msg, *args):
        self.logger.debug(msg, *args)

    def info(self, msg, *args):
        self.logger.info(msg, *args)

    def warning(self, msg, *args):
        self.logger.warning(msg, *args)

    def exception(self, msg="Exception", *args):
        self.logger.exception(msg, *args)
