"""Public-API surface scanner.

Reference: gradle-plugins/api-scanner — writes the public API of each
module to a text file committed to the repo, so API changes show up as
reviewable diffs and accidental breaks fail CI. Here: walk the
corda_tpu_torch packages, emit one sorted line per public class / function /
method with its signature, and compare against `api-current.txt`.

    python -m corda_tpu_torch.tools.api_scanner --write   # refresh the file
    python -m corda_tpu_torch.tools.api_scanner --check   # diff against it

Port of corda_tpu/tools/api_scanner.py over the port's packages, with
its own surface file, `api-current-torch.txt` at the repository root
(the reference's `api-current.txt` records corda_tpu's). One difference:
an object whose own name differs from the public name it is bound to
is left out, so a class bound at run time does not make the surface
depend on the process's history.
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
from typing import Iterable

# The scanned surface: what a CorDapp/tool author programs against.
# (node internals and samples are deliberately out — the reference
# scans its api modules, not node guts.)
API_PACKAGES = (
    "corda_tpu_torch.core",
    "corda_tpu_torch.crypto",
    "corda_tpu_torch.flows",
    "corda_tpu_torch.finance",
    "corda_tpu_torch.client",
    "corda_tpu_torch.testing",
    "corda_tpu_torch.tools",
    "corda_tpu_torch.experimental",
    "corda_tpu_torch.parallel",
    "corda_tpu_torch.utils",
)


def _signature(obj) -> str:
    import re

    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(…)"
    # default values repr with memory addresses are run-dependent
    # (handles nested brackets, e.g. <function C.<lambda> at 0x...>)
    return re.sub(r"<(\w+) .*? at 0x[0-9a-f]+>", r"<\1>", sig)


def _public_members(module) -> Iterable[str]:
    mod_name = module.__name__
    for name, obj in sorted(vars(module).items()):
        if name.startswith("_"):
            continue
        # only symbols defined here (imports are not this module's API)
        if getattr(obj, "__module__", None) != mod_name:
            continue
        # nor private objects bound to a public name at run time (the
        # health canary's lazily registered classes): the scan must not
        # depend on what the process ran before it
        if getattr(obj, "__name__", name) != name:
            continue
        if inspect.isclass(obj):
            bases = [
                b.__name__ for b in obj.__bases__ if b is not object
            ]
            suffix = f"({', '.join(bases)})" if bases else ""
            yield f"class {mod_name}.{name}{suffix}"
            for mname, member in sorted(vars(obj).items()):
                if mname.startswith("_"):
                    continue
                if inspect.isfunction(member):
                    yield (
                        f"  def {mod_name}.{name}.{mname}"
                        f"{_signature(member)}"
                    )
                elif isinstance(member, property):
                    yield f"  val {mod_name}.{name}.{mname}"
                elif isinstance(member, (staticmethod, classmethod)):
                    yield (
                        f"  def {mod_name}.{name}.{mname}"
                        f"{_signature(member.__func__)}"
                    )
        elif inspect.isfunction(obj):
            yield f"def {mod_name}.{name}{_signature(obj)}"


def scan() -> str:
    lines: list[str] = []
    for pkg_name in API_PACKAGES:
        pkg = importlib.import_module(pkg_name)
        mod_names = [pkg_name]
        for info in pkgutil.iter_modules(pkg.__path__):
            if not info.name.startswith("_"):
                mod_names.append(f"{pkg_name}.{info.name}")
        for mod_name in sorted(mod_names):
            module = importlib.import_module(mod_name)
            lines.extend(_public_members(module))
    return "\n".join(lines) + "\n"


def default_path() -> str:
    import corda_tpu_torch

    repo_root = os.path.dirname(
        os.path.dirname(os.path.abspath(corda_tpu_torch.__file__))
    )
    return os.path.join(repo_root, "api-current-torch.txt")


def check(path: str | None = None) -> list[str]:
    """Return a diff (empty == clean) between the live API and the
    committed surface file."""
    import difflib

    path = path or default_path()
    recorded = open(path).read().splitlines() if os.path.exists(path) else []
    live = scan().splitlines()
    return list(
        difflib.unified_diff(
            recorded, live, "api-current-torch.txt", "live API", lineterm="", n=0
        )
    )


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="corda_tpu_torch.tools.api_scanner")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--write", action="store_true")
    group.add_argument("--check", action="store_true")
    parser.add_argument("--path", default=None)
    args = parser.parse_args(argv)
    path = args.path or default_path()
    if args.write:
        with open(path, "w") as f:
            f.write(scan())
        print(f"wrote {path}")
        return 0
    diff = check(path)
    if diff:
        print("\n".join(diff))
        print(
            "\nAPI surface changed; review and refresh with "
            "`python -m corda_tpu_torch.tools.api_scanner --write`"
        )
        return 1
    print("API surface matches api-current-torch.txt")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
