"""Run-length-encoded (Golly-compatible) pattern codec — host side.

Counterpart of carle_tpu/rle.py.  The bodies are encoded and decoded by the
native C codec (native/rle_codec.cpp, built at first use) while
``native.NATIVE`` is on, and by the numpy codec here (``_encode_body_py``,
``_decode_body_py``, the twins that write the same bytes) when it is off.
Both replace the reference's per-cell Python loops (env.py:260-464).  The
wire format is byte-compatible with what the reference writes, with one
deliberate fix: the reference drops up to 69 trailing characters of the
encoding because the final partial line is never flushed before the '!'
terminator (env.py:455-462); we always flush, which is also what Golly
expects.  Files written by the reference still decode correctly here because
the decoder operates on a zero-initialized grid.

The decoder is also robust where the reference's header parser is not: the
reference crashes on its own ':T{h}, {w}' torus tag because its colon check
tests list membership instead of substring (env.py:349-358).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from . import native
from .rules import parse_digits


@dataclass
class RLEPattern:
    """A decoded RLE pattern plus its header metadata."""

    grid: np.ndarray  # uint8 [h, w] of the *declared or inferred* bounding box
    birth: List[int] = field(default_factory=lambda: [3])
    survive: List[int] = field(default_factory=lambda: [2, 3])
    torus: Optional[Tuple[int, int]] = None  # (height, width) from ':T{h}, {w}'
    comments: List[str] = field(default_factory=list)
    body: str = ""  # raw run-length body text (what the reference's
    #               read_rle returns, env.py:330-382)


_HEADER_RE = re.compile(r"rule\s*=\s*([^,\n]+)", re.IGNORECASE)
_XY_RE = re.compile(r"x\s*=\s*(\d+)\s*,\s*y\s*=\s*(\d+)", re.IGNORECASE)
_TORUS_RE = re.compile(r":T\s*(\d+)\s*,\s*(\d+)")


def decode_body(body: str, height: int, width: int) -> np.ndarray:
    """Decode an RLE body string into a uint8 grid of the given shape.

    Semantics match env.py:260-328: 'b' = run of dead cells, 'o' = run of live
    cells, '$' = advance N rows (intervening rows stay dead), '!' terminates,
    newlines are ignored, runs without an explicit count default to 1.
    Content outside the grid bounds is clipped rather than raising.  The
    native codec while ``native.NATIVE`` is on, else :func:`_decode_body_py`.
    """
    if native.NATIVE:
        return native.decode_body(body, height, width)
    return _decode_body_py(body, height, width)


def _decode_body_py(body: str, height: int, width: int) -> np.ndarray:
    """The numpy twin of the native decoder."""
    grid = np.zeros((height, width), dtype=np.uint8)
    row, col = 0, 0
    count_chars: List[str] = []
    for ch in body:
        if ch.isdigit():
            count_chars.append(ch)
        elif ch in ("b", "B", "o", "O"):
            run = int("".join(count_chars)) if count_chars else 1
            count_chars = []
            if ch in ("o", "O") and row < height:
                grid[row, col : min(col + run, width)] = 1
            col += run
        elif ch == "$":
            run = int("".join(count_chars)) if count_chars else 1
            count_chars = []
            row += run
            col = 0
        elif ch == "!":
            break
        # everything else (newlines, stray chars) is ignored
    return grid


def encode_grid(
    grid: np.ndarray,
    birth: List[int],
    survive: List[int],
    exp_id: str = "0",
    step: int = 0,
    action: bool = False,
    torus: Optional[Tuple[int, int]] = None,
    wrap: int = 69,
) -> str:
    """Encode a 2-D binary grid in the reference's exact wire format.

    Header layout matches env.py:408-428 byte for byte; runs are emitted with
    explicit counts even when the run length is 1, exactly as the reference's
    ``str(run_count) + state`` does (env.py:445), so outputs diff cleanly
    against reference-produced files.
    """
    grid = np.asarray(grid)
    if grid.ndim != 2:
        grid = grid.reshape(grid.shape[-2], grid.shape[-1])
    h, w = grid.shape
    if torus is None:
        torus = (h, w)

    header = "#C exp_id={} \n".format(exp_id)
    header += "#C step={} ({}) \n".format(step, "action" if action else "universe")
    header += "x = 0, y = 0, rule = B"
    header += "".join(str(b) for b in sorted(set(birth)))
    header += "/S" + "".join(str(s) for s in sorted(set(survive)))
    header += ":T{}, {}\n".format(torus[0], torus[1])
    if native.NATIVE:
        return header + native.encode_body(grid, wrap=wrap)
    return header + _encode_body_py(grid, wrap)


def _encode_body_py(grid: np.ndarray, wrap: int = 69) -> str:
    """The numpy twin of the native encoder: a 2-D grid's RLE body."""
    w = grid.shape[1]
    cells = grid.astype(np.uint8) != 0
    state_char = ("b", "o")

    lines: List[str] = []
    pending = ""
    for row in cells:
        # vectorized run-length extraction for one row
        changes = np.flatnonzero(row[1:] != row[:-1]) + 1
        starts = np.concatenate(([0], changes))
        ends = np.concatenate((changes, [w]))
        for s, e in zip(starts, ends):
            pending += str(e - s) + state_char[int(row[s])]
            if len(pending) > wrap:
                lines.append(pending)
                pending = ""
        pending += "$"
        if len(pending) > wrap:
            lines.append(pending)
            pending = ""
    if pending:  # reference drops this tail (env.py:455-462); we flush it
        lines.append(pending)
    return "\n".join(lines) + ("\n" if lines else "") + "!"


def parse_rle_text(text: str) -> RLEPattern:
    """Parse a full RLE file's text (header + body) into an :class:`RLEPattern`.

    Headerless text (a bare run-length body, e.g. what ``read_rle`` returns
    — fed back through ``rle_to_grid`` the way the reference's MorphoBonus
    does, mcl.py:148-149) is accepted too: with no header line anywhere,
    every non-comment line is body."""
    birth, survive = [3], [2, 3]
    torus = None
    comments: List[str] = []
    declared: Optional[Tuple[int, int]] = None
    body_lines: List[str] = []
    seen_header = False
    # pre-scan: if a header exists, pre-header junk lines are SKIPPED (the
    # old behaviour — 'Generated by x' preambles must not decode as body:
    # their 'b'/'o' letters would corrupt row 0)
    has_header = any(
        not l.strip().startswith("#")
        and (_HEADER_RE.search(l) or _XY_RE.search(l))
        for l in text.splitlines()
    )

    for line in text.splitlines():
        stripped = line.strip()
        if stripped.startswith("#"):
            comments.append(stripped)
            continue
        m = _HEADER_RE.search(stripped)
        if not seen_header and (m or _XY_RE.search(stripped)):
            seen_header = True
            if m:
                rule_text = m.group(1)
                tm = _TORUS_RE.search(stripped)
                if tm:
                    torus = (int(tm.group(1)), int(tm.group(2)))
                parts = rule_text.split("/")
                if len(parts) >= 2:
                    b = parse_digits(parts[0])
                    s = parse_digits(parts[1].split(":")[0])
                    # Golly also allows 'S23/B3' ordering; detect by prefix.
                    if "s" in parts[0].lower() and "b" in parts[1].lower():
                        b, s = s, b
                    birth, survive = b, s
            xym = _XY_RE.search(stripped)
            if xym:
                declared = (int(xym.group(2)), int(xym.group(1)))  # (h, w)
            continue
        if has_header and not seen_header:
            continue  # pre-header preamble: not body
        body_lines.append(line)
        if "!" in line:
            break

    body = "\n".join(body_lines)
    if declared is None or declared[0] == 0 or declared[1] == 0:
        h, w = _infer_extent(body)
    else:
        h, w = declared
    if torus is not None:
        h, w = torus
    grid = decode_body(body, max(h, 1), max(w, 1))
    return RLEPattern(grid=grid, birth=birth, survive=survive, torus=torus,
                      comments=comments, body=body)


def _infer_extent(body: str) -> Tuple[int, int]:
    """Compute the bounding box an RLE body needs, for headers with x=0,y=0
    (the reference always writes 'x = 0, y = 0' regardless of content,
    env.py:424)."""
    rows = 1
    col = 0
    max_col = 0
    pending_rows = 0  # '$' runs count only once content follows: the
    # encoder writes '$' after EVERY row including the last (byte parity
    # with the reference), so eagerly counting them inferred h+1 rows for
    # any encoder-produced body — a phantom dead row through the
    # rle_to_grid(read_rle(path)) chain
    count_chars: List[str] = []
    for ch in body:
        if ch.isdigit():
            count_chars.append(ch)
        elif ch in ("b", "B", "o", "O"):
            run = int("".join(count_chars)) if count_chars else 1
            count_chars = []
            rows += pending_rows
            pending_rows = 0
            col += run
            max_col = max(max_col, col)
        elif ch == "$":
            run = int("".join(count_chars)) if count_chars else 1
            count_chars = []
            pending_rows += run
            col = 0
        elif ch == "!":
            break
    # Trailing '$' runs: drop exactly ONE (the encoder's terminator after the
    # last row) but keep the rest — a foreign headerless body that ends with
    # deliberate blank rows (e.g. 'o2$!') must infer its full height.
    rows += max(pending_rows - 1, 0)
    return rows, max_col


def read_rle(path: str) -> RLEPattern:
    with open(path, "r") as f:
        return parse_rle_text(f.read())


def read_log(path: str) -> List[Tuple[str, str]]:
    """Read an episode-log CSV written by ``CARLE.save_log`` back into
    (action_rle, universe_rle) text pairs.

    The reference declares ``read_csv`` but leaves it a stub (env.py:384-388);
    this is the working implementation.  The log format quotes each RLE blob
    (which contains newlines), so parsing goes through the csv module.
    """
    import csv

    pairs: List[Tuple[str, str]] = []
    with open(path, "r", newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        for row in reader:
            if len(row) >= 2 and row[0]:
                pairs.append((row[0], row[1]))
    return pairs


def write_log(path: str, entries: List[List[str]]) -> None:
    """Write (action_rle, universe_rle) entries as the reference's CSV
    episode log: each RLE blob quoted, a trailing comma, a line an entry
    (``CARLE.save_log``, ``Rollout.run_logged``)."""
    with open(path, "w") as f:
        f.write("action,universe,\n")
        for entry in entries:
            for item in entry:
                f.write('"' + item + '"' + ",")
            f.write("\n")


def write_rle(path: str, rle_text: str) -> None:
    with open(path, "w") as f:
        f.write(rle_text)
