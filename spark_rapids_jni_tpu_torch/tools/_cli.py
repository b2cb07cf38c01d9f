"""What the reading CLIs share: the store directory, an entry by path or
index, and a quiet exit when a pager closes the pipe."""

from __future__ import annotations

import os
import sys


def dir_of(args, fallback: str, what: str) -> str:
    """``--dir``, else the in-process config field ``fallback``; exit 2
    when neither names a directory."""
    d = args.dir or fallback
    if not d:
        print(f"{what} dir not set (use --dir)", file=sys.stderr)
        raise SystemExit(2)
    return d


def resolve(d: str, spec: str | None, paths: list, noun: str) -> str:
    """A path, or a negative index into the chronological ring (-1 =
    newest); default newest."""
    if spec and not spec.lstrip("-").isdigit():
        return spec if os.path.sep in spec else os.path.join(d, spec)
    if not paths:
        print(f"no {noun}s in {d}", file=sys.stderr)
        raise SystemExit(2)
    idx = int(spec) if spec else -1
    try:
        return paths[idx]
    except IndexError:
        print(f"index {idx} out of range ({len(paths)} {noun}s)",
              file=sys.stderr)
        raise SystemExit(2)


def run(main) -> None:
    """``raise SystemExit(main())``; a downstream pager or ``head`` that
    closed the pipe mid-print is a normal exit (stdout goes to devnull
    first so interpreter teardown cannot raise again)."""
    try:
        code = main()
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        code = 0
    raise SystemExit(code)
