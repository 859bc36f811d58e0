"""Console entry points of the installed port (``pyproject.toml``
``[project.scripts]``): ``cgtorch-tester`` runs the port's harness and
``cgtorch-make-problem`` its problem generator.  Counterpart of
``conjugategradient_tpu/cli.py``; both programs are modules of this
package, so no path setup is needed."""

from __future__ import annotations


def tester_main() -> int:
    from .tester import main

    return main()


def make_problem_main() -> int:
    from .make_problem import main

    return main()
