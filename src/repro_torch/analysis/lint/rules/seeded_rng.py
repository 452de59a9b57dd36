"""SL003 — seeded, explicit RNG only inside ``src/repro_torch/``.

Every stochastic component of the port — the EA/anneal engines, the
online trace generators, the models' random weights — is reproducible
because randomness flows from an explicit ``np.random.default_rng(seed)``
``Generator`` on the host or a ``torch.Generator`` passed as
``generator=`` (``models/layers.py``).  Module-level ``np.random.<fn>``
calls mutate numpy's hidden *global* bit stream, the stdlib ``random``
module is a second, unseeded stream, and torch has a third: its default
generators, which ``torch.manual_seed`` reseeds for the whole process and
every draw without ``generator=`` consumes, so an unrelated draw anywhere
shifts every later one.

Findings:

* the reference's: ``np.random.<fn>`` draws and the stdlib ``random``
  module;
* ``torch.manual_seed`` / ``torch.seed`` / ``torch.cuda.manual_seed*``
  (and their ``torch.random`` / ``torch.cuda`` forms);
* a ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` / ``normal``
  / ``bernoulli`` / ``multinomial`` / ``poisson`` / ``*_like`` call, or a
  drawing ``torch.nn.init`` initialiser, without ``generator=``;
* the in-place samplers ``Tensor.uniform_`` / ``normal_`` / ``random_`` /
  ``bernoulli_`` / ``exponential_`` / ``cauchy_`` / ``log_normal_`` /
  ``geometric_`` without ``generator=``.

Allowed: ``default_rng`` / explicit numpy ``Generator`` and bit-generator
construction (``SeedSequence``, ``PCG64``, ...), and ``torch.Generator``
(seeded with its own ``.manual_seed``).
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..context import ModuleContext
from ..findings import Finding
from .base import ProjectIndex, Rule, register

# explicit-seeding constructors on numpy.random that are fine to call
ALLOWED_NP_RANDOM = frozenset({
    "BitGenerator", "Generator", "MT19937", "PCG64", "PCG64DXSM", "Philox",
    "SFC64", "SeedSequence", "default_rng",
})

# calls that reseed a torch default generator
TORCH_GLOBAL_SEEDERS = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
})
# torch draws that take ``generator=``
TORCH_DRAWS = frozenset({
    "torch.bernoulli", "torch.multinomial", "torch.normal",
    "torch.poisson", "torch.rand", "torch.rand_like", "torch.randint",
    "torch.randint_like", "torch.randn", "torch.randn_like",
    "torch.randperm",
})
# ``torch.nn.init`` initialisers that draw (they take ``generator=``)
TORCH_INIT_DRAWS = frozenset({
    "kaiming_normal_", "kaiming_uniform_", "normal_", "orthogonal_",
    "sparse_", "trunc_normal_", "uniform_", "xavier_normal_",
    "xavier_uniform_",
})
# in-place samplers of a tensor
TENSOR_SAMPLERS = frozenset({
    "bernoulli_", "cauchy_", "exponential_", "geometric_", "log_normal_",
    "normal_", "random_", "uniform_",
})


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


@register
class SeededRngRule(Rule):
    """Forbid global-stream RNG: numpy, stdlib and torch default streams."""

    rule_id = "SL003"
    title = ("randomness must come from np.random.default_rng(seed) / "
             "torch.Generator passed as generator=, never global streams")

    def check(self, ctx: ModuleContext,
              project: ProjectIndex) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "random" or alias.name.startswith(
                            "random."):
                        yield self.finding(
                            ctx, node,
                            "stdlib 'random' is an unseeded global stream — "
                            "use np.random.default_rng(seed)")
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and node.module == "random":
                    yield self.finding(
                        ctx, node,
                        "stdlib 'random' is an unseeded global stream — "
                        "use np.random.default_rng(seed)")
            elif isinstance(node, ast.Call):
                yield from self._call(ctx, node)

    def _call(self, ctx: ModuleContext,
              node: ast.Call) -> Iterator[Finding]:
        name = ctx.call_name(node)
        if name is None:
            func = node.func
            if (isinstance(func, ast.Attribute)
                    and func.attr in TENSOR_SAMPLERS
                    and not _has_generator(node)):
                yield self.finding(
                    ctx, node,
                    f"'.{func.attr}(...)' without generator= draws from "
                    "torch's default generator — pass an explicit "
                    "torch.Generator")
            return
        if name.startswith("numpy.random."):
            leaf = name.rsplit(".", 1)[-1]
            if leaf not in ALLOWED_NP_RANDOM:
                yield self.finding(
                    ctx, node,
                    f"'{name}' draws from the hidden global numpy "
                    "stream — construct a Generator via "
                    "np.random.default_rng(seed) and draw from it")
        elif name.startswith("random.") and name.count(".") == 1:
            yield self.finding(
                ctx, node,
                f"stdlib '{name}' is unseeded global-stream RNG — "
                "use an explicit seeded Generator")
        elif name in TORCH_GLOBAL_SEEDERS:
            yield self.finding(
                ctx, node,
                f"'{name}' reseeds torch's process-wide default "
                "generator — seed an explicit torch.Generator and pass "
                "it as generator=")
        elif (name in TORCH_DRAWS or (
                name.startswith("torch.nn.init.")
                and name.rsplit(".", 1)[-1] in TORCH_INIT_DRAWS)) \
                and not _has_generator(node):
            yield self.finding(
                ctx, node,
                f"'{name}' without generator= draws from torch's default "
                "generator — pass an explicit torch.Generator")
