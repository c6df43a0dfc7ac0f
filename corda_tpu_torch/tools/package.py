"""Self-contained runnable artefact builder (capsule analogue).

Reference: node/capsule/ + webserver/webcapsule/ — gradle tasks that
pack the node / webserver into single runnable fat jars (`corda.jar`,
`corda-webserver.jar`). The python-native equivalent is a zipapp: one
`.pyz` file embedding the whole corda_tpu_torch package with a chosen
entry point, runnable as `python corda.pyz --config node.toml`
anywhere the interpreter + baked-in deps exist.

Port of corda_tpu/tools/package.py. The artefact embeds the CUDA
sources (`csrc/*.cu`, `csrc/*.cuh`) and the native C++ beside the
Python, but nvcc and g++ read only from the file system: a node started
from the .pyz that reaches a kernel raises KernelBuildError naming the
archive (crypto/build.py), and never verifies on the CPU in its place.
Run the node from an unpacked tree to build its kernels.
"""

from __future__ import annotations

import os
import py_compile
import zipfile

ENTRY_POINTS = {
    "node": "corda_tpu_torch.node.__main__",
    "webserver": "corda_tpu_torch.client.webserver",
    "demobench": "corda_tpu_torch.tools.demobench",
    "explorer": "corda_tpu_torch.tools.explorer",
}


def build_zipapp(
    output: str,
    entry: str = "node",
    package_root: str | None = None,
) -> str:
    """Pack corda_tpu_torch into a runnable .pyz with `entry`'s main() as
    __main__ (capsule's role). Returns the output path."""
    if entry not in ENTRY_POINTS:
        raise ValueError(
            f"unknown entry {entry!r}; choose from {sorted(ENTRY_POINTS)}"
        )
    module = ENTRY_POINTS[entry]
    if package_root is None:
        import corda_tpu_torch

        package_root = os.path.dirname(
            os.path.dirname(os.path.abspath(corda_tpu_torch.__file__))
        )
    pkg_dir = os.path.join(package_root, "corda_tpu_torch")
    if not os.path.isdir(pkg_dir):
        raise FileNotFoundError(f"no corda_tpu_torch package under {package_root}")
    with zipfile.ZipFile(output, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith((".py", ".cpp", ".cu", ".cuh", ".so", ".toml")):
                    full = os.path.join(dirpath, fn)
                    arc = os.path.relpath(full, package_root)
                    # catch syntax errors at build time, like javac
                    if fn.endswith(".py"):
                        py_compile.compile(full, doraise=True)
                    zf.write(full, arc)
        zf.writestr(
            "__main__.py",
            "import runpy, sys\n"
            f"runpy.run_module({module!r}, run_name='__main__')\n",
        )
    return output


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="corda_tpu_torch.tools.package",
        description="Build a runnable .pyz artefact (capsule analogue)",
    )
    parser.add_argument("output", help="e.g. corda.pyz")
    parser.add_argument(
        "--entry", default="node", choices=sorted(ENTRY_POINTS)
    )
    args = parser.parse_args(argv)
    path = build_zipapp(args.output, args.entry)
    print(f"built {path} (entry: {args.entry})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
