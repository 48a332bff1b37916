"""Package version and output-file provenance.

Fills the role of the reference's ``calamity/version.py`` (git-shelling
version info + ``history_string`` headers for written files) with a fresh
implementation: the installed distribution version comes from
``importlib.metadata`` when available, and the git state is probed ONCE at
import into a module-level snapshot that every ``history_string`` call
reuses (the reference re-shells git per written file).

Copy of calamity_tpu/version.py for the port: the git state is probed in
this package's own directory, and ``history_string`` writes the same
provenance block as the JAX package, so files written by either package
compare like with like.
"""

from __future__ import annotations

import os
import subprocess
from dataclasses import dataclass, field
from datetime import datetime, timezone

_PKG_DIR = os.path.dirname(os.path.realpath(__file__))

try:  # installed distribution metadata, if any
    from importlib.metadata import PackageNotFoundError
    from importlib.metadata import version as _dist_version

    try:
        __version__ = _dist_version("calamity-tpu")
    except PackageNotFoundError:
        __version__ = "0.1.0"
except ImportError:  # pragma: no cover
    __version__ = "0.1.0"


@dataclass
class GitState:
    """Snapshot of the repository state the package is running from."""

    commit: str = ""
    branch: str = ""
    origin: str = ""
    dirty: bool = False
    describe: str = ""

    def as_dict(self):
        return {
            "commit": self.commit,
            "branch": self.branch,
            "origin": self.origin,
            "dirty": self.dirty,
            "describe": self.describe,
        }


def probe_git_state(path=_PKG_DIR):
    """Best-effort git snapshot; empty fields when not in a checkout.

    Only reports a repository that actually CONTAINS the package source:
    ``git -C`` walks upward, so a wheel install inside someone's analysis
    repo would otherwise stamp that unrelated repo's commit/branch/origin
    into every written file's provenance."""
    state = GitState()

    def run(*args):
        return subprocess.run(
            ["git", "-C", path, *args],
            capture_output=True, text=True, timeout=10,
        )

    try:
        top = run("rev-parse", "--show-toplevel")
        if top.returncode != 0:
            return state
        toplevel = os.path.realpath(top.stdout.strip())
        realpath = os.path.realpath(path)
        if realpath != toplevel and not realpath.startswith(toplevel + os.sep):
            return state  # enclosing repo is not this package's checkout
        head = run("log", "-1", "--format=%H")
        if head.returncode != 0:
            return state
        state.commit = head.stdout.strip()
        state.branch = run("branch", "--show-current").stdout.strip()
        state.origin = run("remote", "get-url", "origin").stdout.strip()
        state.dirty = bool(run("status", "--porcelain").stdout.strip())
        desc = run("describe", "--tags", "--always").stdout.strip()
        state.describe = desc + ("-dirty" if state.dirty else "")
    except (OSError, subprocess.TimeoutExpired):  # pragma: no cover
        pass
    return state


@dataclass
class VersionInfo:
    version: str = __version__
    git: GitState = field(default_factory=probe_git_state)

    def __getitem__(self, key):
        # mapping-style access for reference-API compatibility
        # (construct_version_info() returned a dict)
        if key == "version":
            return self.version
        mapped = {
            "git_origin": self.git.origin,
            "git_hash": self.git.commit,
            "git_branch": self.git.branch,
            "git_description": self.git.describe,
        }
        return mapped[key]


def construct_version_info():
    """Reference-named accessor: package + git provenance snapshot."""
    return VersionInfo()


def history_string(notes=""):
    """Provenance block appended to the ``history`` of written files.

    Same role as the reference's history_string (version.py:76-88): record
    enough to trace an output file back to the code that made it. Reuses
    the import-time snapshot — the git state cannot change under a running
    process in a way worth five subprocesses per written file.
    """
    info = version_info
    lines = [
        "",
        "[calamity_tpu provenance]",
        f"  written: {datetime.now(timezone.utc).isoformat(timespec='seconds')}",
        f"  version: {info.version}",
    ]
    if info.git.commit:
        lines.append(f"  git: {info.git.describe} ({info.git.branch})")
    if info.git.origin:
        lines.append(f"  origin: {info.git.origin}")
    if notes:
        lines.append(f"  notes: {notes}")
    lines.append("[end provenance]")
    return "\n".join(lines) + "\n"


# module-level snapshot (import-time, like the reference's tail)
version_info = construct_version_info()
version = version_info.version
git_hash = version_info.git.commit
git_branch = version_info.git.branch
git_origin = version_info.git.origin
git_description = version_info.git.describe


def main():  # pragma: no cover
    for k, v in {"version": version, **version_info.git.as_dict()}.items():
        print(f"{k}: {v}")


if __name__ == "__main__":  # pragma: no cover
    main()
