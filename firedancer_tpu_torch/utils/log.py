"""Leveled logging in the reference's style (src/util/log/fd_log.h:23-45:
DEBUG/INFO/NOTICE/WARNING/ERR/CRIT/ALERT/EMERG).

The port's own copy of firedancer_tpu/utils/log.py: a thin layer over
python logging with the same level vocabulary and the same "ERR exits
the tile" contract (FD_LOG_ERR ends the process so the supervisor can
restart the topology, src/app/fdctl/run/run.c:279)."""

import logging
import sys

NOTICE = 25
logging.addLevelName(NOTICE, "NOTICE")

_logger = logging.getLogger("firedancer_tpu_torch")

# per-process log context: which tile this process is, and its restart
# generation (fd_log's thread-local app/thread tags, fd_log.h:150).
# "-" = the supervisor / a non-tile process.
_ctx = {"tag": "-"}


def set_context(tile: str, gen: int = 0):
    """Tag every later record from this process with the tile name (and
    `#gen` once the supervisor has respawned it), so interleaved
    multi-tile stderr attributes each line."""
    _ctx["tag"] = f"{tile}#{gen}" if gen > 0 else (tile or "-")


class _Ctx(logging.Filter):
    def filter(self, record):
        record.tile = _ctx["tag"]
        return True


_logger.addFilter(_Ctx())


def boot(log_path: str | None = None, level: str = "NOTICE"):
    """fd_boot-style logging init (fd_util.h:50-100 boot options)."""
    _logger.setLevel(logging.DEBUG)
    _logger.handlers.clear()
    eph = logging.StreamHandler(sys.stderr)
    eph.setLevel(getattr(logging, level, NOTICE) if level != "NOTICE"
                 else NOTICE)
    eph.setFormatter(
        logging.Formatter("%(levelname)-7s %(process)d %(tile)s %(message)s"))
    eph.addFilter(_Ctx())   # handler-level too: stamps records that
    _logger.addHandler(eph)  # propagate from child loggers
    if log_path:
        fh = logging.FileHandler(log_path)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-7s %(process)d %(tile)s %(message)s"))
        fh.addFilter(_Ctx())
        _logger.addHandler(fh)
    return _logger


def debug(msg, *a):
    _logger.debug(msg, *a)


def info(msg, *a):
    _logger.info(msg, *a)


def notice(msg, *a):
    _logger.log(NOTICE, msg, *a)


def warning(msg, *a):
    _logger.warning(msg, *a)


def err(msg, *a):
    """Log and exit: the supervision tree treats any tile death as fatal
    for the whole topology (fail-fast, run.c:279)."""
    _logger.error(msg, *a)
    sys.exit(1)
