"""Machine-level config + git working-tree snapshots.

Port of ``erc_tpu.core.machine`` (which imports no JAX, but its package
does): the same config files and ``ERC_TPU_*`` environment variables, so
that one machine config serves both packages.

Config (reference: lumo/proc/config.py — ``~/.lumorc.json`` global merged
with ``<git root>/.lumorc.json`` local): here ``~/.erc_tpurc.json`` +
``<git root>/.erc_tpurc.json``.  Recognized keys: ``exproot``,
``data_root``, ``cache_dir``, ``git_snapshot``.  Environment variables
(ERC_TPU_EXPROOT / ERC_TPU_DATA_ROOT / ...) take precedence over both.

Snapshots (reference: lumo/utils/repository.py:84-137 + exphook.py
GitCommit): record the *working tree* — tracked changes and untracked
files — as a commit on a dedicated branch so every run is reproducible
even with uncommitted edits.  Unlike the reference's
``reset → add → commit → reset`` dance on the live index, this uses a
temporary ``GIT_INDEX_FILE`` with plumbing commands (``add -A`` →
``write-tree`` → ``commit-tree`` → ``update-ref``), so the user's index,
HEAD and working tree are never touched and crashes cannot strand the
repo on the snapshot branch.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
from functools import lru_cache
from typing import Optional

SNAPSHOT_BRANCH = "erc_tpu_snapshots"


def _run_git(args, cwd=None, env=None, timeout=30):
    return subprocess.run(
        ["git"] + args, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout
    )


def git_root(path: str = ".") -> Optional[str]:
    try:
        r = _run_git(["rev-parse", "--show-toplevel"], cwd=path, timeout=5)
        return r.stdout.strip() or None
    except Exception:
        return None


# ---------------------------------------------------------------- config
def global_config_path() -> str:
    return os.path.expanduser("~/.erc_tpurc.json")


def local_config_path() -> Optional[str]:
    root = git_root()
    return os.path.join(root, ".erc_tpurc.json") if root else None


def _read_json(path: Optional[str]) -> dict:
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                return json.load(f)
        except Exception:
            pass
    return {}


@lru_cache(maxsize=8)
def _config_cached(global_path: Optional[str], local_path: Optional[str]) -> dict:
    cfg = _read_json(global_path)
    cfg.update(_read_json(local_path))
    return cfg


def machine_config() -> dict:
    # keyed by the resolved paths: chdir into another repo (or `cli init`
    # followed by use in the same process) picks up the right local rc
    return _config_cached(global_config_path(), local_config_path())


machine_config.cache_clear = _config_cached.cache_clear


def cfg_get(key: str, env: Optional[str] = None, default=None):
    """env var > local rc > global rc > default.  Explicit JSON nulls (the
    `cli init` skeleton) count as missing."""
    if env and os.environ.get(env):
        return os.environ[env]
    v = machine_config().get(key)
    return default if v is None else v


# -------------------------------------------------------------- snapshots
def git_snapshot(
    repo_dir: Optional[str] = None,
    branch: str = SNAPSHOT_BRANCH,
    message: Optional[str] = None,
) -> Optional[str]:
    """Commit the working tree onto ``branch`` without touching the user's
    index/HEAD.  Returns the snapshot commit hash (the branch head is
    reused when nothing changed), or None outside a git repo / on error."""
    root = git_root(repo_dir or ".")
    if root is None:
        return None
    try:
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, GIT_INDEX_FILE=os.path.join(tmp, "index"))
            if _run_git(["add", "-A", "."], cwd=root, env=env).returncode != 0:
                return None
            tree = _run_git(["write-tree"], cwd=root, env=env).stdout.strip()
            if not tree:
                return None
            head = _run_git(["rev-parse", "--verify", "-q", f"refs/heads/{branch}"], cwd=root)
            parent = head.stdout.strip() or None
            if parent:
                parent_tree = _run_git(
                    ["rev-parse", f"{parent}^{{tree}}"], cwd=root
                ).stdout.strip()
                if parent_tree == tree:
                    return parent  # dedup: identical working tree
            args = ["commit-tree", tree, "-m", message or "erc_tpu run snapshot"]
            if parent:
                args += ["-p", parent]
            commit = _run_git(args, cwd=root, env=env).stdout.strip()
            if not commit:
                return None
            _run_git(["update-ref", f"refs/heads/{branch}", commit], cwd=root)
            return commit
    except Exception:
        return None


def archive_snapshot(commit: str, output: str, repo_dir: Optional[str] = None) -> bool:
    """``git archive`` a snapshot commit to a zip/tar (reference cli
    ``lumo archive``)."""
    root = git_root(repo_dir or ".")
    if root is None:
        return False
    output = os.path.abspath(output)  # git runs with cwd=root
    fmt = "zip" if output.endswith(".zip") else "tar"
    r = _run_git(["archive", f"--format={fmt}", "-o", output, commit], cwd=root, timeout=120)
    return r.returncode == 0


def snapshot_enabled() -> bool:
    v = cfg_get("git_snapshot", env="ERC_TPU_GIT_SNAPSHOT", default=True)
    return str(v).lower() not in ("0", "false", "no", "off")
