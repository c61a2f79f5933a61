"""Each test whose `cell` parameter names a cell thinned through its
configuration's keys (`sizes.thinned_by_its_config`) runs it at that
configuration's tiny size (`sizes.TINY_R101`) in place of
`helpers.TINY`."""

from __future__ import annotations

import pytest

from benchmark.tests import helpers, sizes


@pytest.fixture(autouse=True)
def _tiny_size_of_the_cell(request, monkeypatch):
    spec = getattr(request.node, "callspec", None)
    cell = spec.params.get("cell") if spec is not None else None
    if isinstance(cell, str) and sizes.thinned_by_its_config(cell):
        monkeypatch.setattr(helpers, "TINY", sizes.TINY_R101)
