"""The benchmark's own tests: `python -m pytest benchmarks/tests -q` from the
root of the repository. Tests that need a CUDA card carry the `card` marker
and skip without one."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
