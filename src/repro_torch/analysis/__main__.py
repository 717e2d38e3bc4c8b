"""``python -m repro_torch.analysis [paths...]``: the port's linter over
``src/repro_torch`` and ``examples/*_torch.py`` (or ``paths``), run from
the repository's root; exits 1 on any finding."""
from repro_torch.analysis.lint import main

raise SystemExit(main())
