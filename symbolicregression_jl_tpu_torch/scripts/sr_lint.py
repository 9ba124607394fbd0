#!/usr/bin/env python
"""sr-lint CLI — the port's project-specific linter (torch rule set).

Usage:
    python symbolicregression_jl_tpu_torch/scripts/sr_lint.py symbolicregression_jl_tpu_torch/
    python symbolicregression_jl_tpu_torch/scripts/sr_lint.py --json symbolicregression_jl_tpu_torch/
    python symbolicregression_jl_tpu_torch/scripts/sr_lint.py --show-suppressed symbolicregression_jl_tpu_torch/
    python symbolicregression_jl_tpu_torch/scripts/sr_lint.py --list-rules
    (or python -m symbolicregression_jl_tpu_torch.scripts.sr_lint ...)

Exit status: 0 when no unsuppressed findings, 1 otherwise, 2 on usage error.

Loads ``analysis/lint.py`` by file path (pure stdlib), so run as a file it
imports neither torch nor the port package.
"""

import argparse
import importlib.util
import os
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LINT_PY = os.path.join(_PKG, "analysis", "lint.py")


def _load_lint():
    spec = importlib.util.spec_from_file_location("sr_lint_torch_impl", _LINT_PY)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["sr_lint_torch_impl"] = mod  # dataclasses resolves the module by name
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sr-lint", description=__doc__)
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--json", action="store_true", help="emit findings as JSON")
    ap.add_argument(
        "--show-suppressed",
        action="store_true",
        help="include suppressed findings in the report (never affect exit status)",
    )
    ap.add_argument("--list-rules", action="store_true", help="print the rule table")
    args = ap.parse_args(argv)

    lint = _load_lint()

    if args.list_rules:
        for rid, (slug, desc) in sorted(lint.RULES.items()):
            print(f"{rid}  {slug}\n    {desc}")
        return 0

    if not args.paths:
        ap.print_usage(sys.stderr)
        return 2

    findings = lint.lint_paths(args.paths)
    shown = findings if args.show_suppressed else [f for f in findings if not f.suppressed]
    if args.json:
        print(lint.render_json(shown))
    else:
        for f in shown:
            print(f.render())
    unsuppressed = [f for f in findings if not f.suppressed]
    if not args.json and unsuppressed:
        print(f"\n{len(unsuppressed)} finding(s).", file=sys.stderr)
    return 1 if unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
