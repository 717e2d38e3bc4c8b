"""The port's linter (``repro_torch.analysis.lint``): each rule on seeded
bad modules, the pragmas, the move-stable keys, and the port itself
(``src/repro_torch`` and ``examples/*_torch.py``) clean with no baseline.
"""
import doctest
import pathlib
import textwrap

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import lint                               # noqa: E402
from repro_torch.analysis.lint import (RULES, Finding,              # noqa: E402
                                       lint_paths, lint_source)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _src(text: str) -> str:
    return textwrap.dedent(text).lstrip("\n")


#: rule -> (a module that must trip it, the line of the finding)
BAD = {
    "wall-clock": ("""
        import time
        def step():
            return time.perf_counter()
        """, 3),
    "unseeded-random/torch-sampler": ("""
        import torch
        def init(n):
            return torch.randn(n, 3)
        """, 3),
    "unseeded-random/manual-seed": ("""
        import torch
        torch.manual_seed(0)
        """, 2),
    "unseeded-random/in-place": ("""
        def init(w):
            w.uniform_(-1.0, 1.0)
        """, 2),
    "unseeded-random/numpy-global": ("""
        import numpy as np
        x = np.random.normal(size=3)
        """, 2),
    "unseeded-random/stdlib": ("""
        import random
        def jitter():
            return random.uniform(0, 1)
        """, 3),
    "bare-except": ("""
        def f():
            try:
                return 1
            except:
                return 0
        """, 4),
    "host-sync/launch-site": ("""
        from .record import launch_site
        @launch_site("k")
        def entry(x):
            n = x.sum().item()
            return x * n
        """, 4),
    "host-sync/cuda-graph-call": ("""
        from repro_torch.models.backend import CudaGraphCall
        def step(clouds):
            return helper(clouds)
        def helper(clouds):
            return clouds.max().item()
        call = CudaGraphCall(step, (None,))
        """, 5),
    "host-sync/step-graphs": ("""
        from repro_torch.models.backend import StepGraphs
        def make():
            graphs = StepGraphs()
            def step(state, batch):
                def train_step(x):
                    return float(x.sum().cpu())
                return graphs(train_step, [], (batch,))
            return step
        """, 6),
    "host-sync/replay": ("""
        class Model:
            def jit_loss(self, x):
                return self._replay(self.loss, x)
            def loss(self, x):
                return x.cpu()
        """, 5),
    "host-sync/graph-block": ("""
        import torch
        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                torch.cuda.synchronize()
        """, 5),
    "host-sync/eval-step": ("""
        import numpy as np
        class Model:
            def eval_step(self, x):
                return np.asarray(x)
        """, 4),
    "host-sync/tolist": ("""
        class Model:
            def jit_forward(self, x):
                return x.tolist()
        """, 3),
    "plain-pinned": ("""
        from . import _build
        from .record import launch_site
        @launch_site("k")
        def entry(x):
            out = entry_plain(x)
            if _build.runs_plain(x):
                return out
            return entry_cuda(x)
        """, 5),
    "plain-pinned/ref-twin": ("""
        from .record import launch_site
        @launch_site("k")
        def entry(x):
            return ref_entry(x)
        """, 4),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_seeded_bad_module_trips_its_rule(case):
    source, line = BAD[case]
    rule = case.split("/")[0]
    found = [(f.rule, f.line) for f in lint_source(_src(source))]
    assert found == [(rule, line)]


#: modules each rule must leave alone
GOOD = {
    "seeded samplers": """
        import numpy as np
        import torch
        def init(n, gen, w):
            rng = np.random.default_rng(0)
            w.normal_(generator=gen)
            return torch.randn(n, generator=gen), rng.normal(size=3)
        """,
    "a sync outside any capture site": """
        def report(x):
            return x.item(), x.cpu().numpy(), x.tolist()
        """,
    "a literal array in a captured function": """
        import numpy as np
        class Model:
            def jit_forward(self, x):
                return np.asarray([1, 2, 3])
        """,
    "plain versions under the runs_plain branch": """
        from . import _build
        from .record import launch_site
        @launch_site("k")
        def entry(x):
            if _build.runs_plain(x):
                return entry_plain(x)
            return entry_cuda(x)
        @launch_site("j")
        def other(x):
            return other_plain(x) if _build.runs_plain(x) else other_cuda(x)
        """,
    "a named exception": """
        def f():
            try:
                return 1
            except ValueError:
                return 0
        """,
}


@pytest.mark.parametrize("case", sorted(GOOD))
def test_clean_modules_have_no_finding(case):
    assert lint_source(_src(GOOD[case])) == []


@pytest.mark.parametrize("where", ["same line", "line above"])
def test_pragmas_silence_their_rule(where):
    site = "        return x.item()"
    pragma = "# lint: allow-host-sync — read after the replay"
    body = (f"{site}  {pragma}" if where == "same line"
            else f"        {pragma}\n{site}")
    source = f"class M:\n    def jit_forward(self, x):\n{body}\n"
    assert lint_source(source) == []
    other = source.replace("allow-host-sync", "allow-wall-clock")
    assert [f.rule for f in lint_source(other)] == ["host-sync"]


def test_keys_are_stable_under_line_moves():
    source, _ = BAD["wall-clock"]
    a = lint_source(_src(source))
    b = lint_source("\n\n\n# moved\n" + _src(source))
    assert [f.line for f in a] != [f.line for f in b]
    assert [f.key for f in a] == [f.key for f in b]
    assert Finding("r", "p.py", 1, 1, "m", "x = 1").key == \
        Finding("r", "p.py", 9, 4, "n", "x = 1").key


def test_rules_are_the_references_counterparts():
    assert set(RULES) == {"wall-clock", "unseeded-random", "bare-except",
                          "host-sync", "plain-pinned"}
    assert "mutable-pytree" in lint.__doc__
    with pytest.raises(ValueError, match="unknown lint rule"):
        lint_source("x = 1\n", rules=["interpret-pinned"])


def test_lint_paths_recurses_and_reports_parse_errors(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "bad.py").write_text("import time\nt = time.time()\n")
    (pkg / "broken.py").write_text("def f(:\n")
    (pkg / "ok.py").write_text("x = 1\n")
    found = [(f.path, f.rule) for f in lint_paths([tmp_path], root=tmp_path)]
    assert found == [("pkg/bad.py", "wall-clock"),
                     ("pkg/broken.py", "parse-error")]


def test_module_doctest():
    assert doctest.testmod(lint).failed == 0


def test_the_port_is_lint_clean_with_no_baseline():
    paths = [ROOT / "src" / "repro_torch",
             *sorted((ROOT / "examples").glob("*_torch.py"))]
    assert len(paths) >= 4
    findings = lint_paths(paths, root=ROOT)
    assert findings == [], "\n".join(map(str, findings))
