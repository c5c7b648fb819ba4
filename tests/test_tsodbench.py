"""The benchmark's own tests (``tsodbench/tests/``), collected with the
repo's tests: its harness and contract (every name, unit and key of
``BENCHMARK.json``), its work counts, its reference, its output check and
planted faults, and its trace reader, with the fixtures of their conftest.
CPU only; the one card test skips here."""

from tsodbench.tests import (test_tsod_counts, test_tsod_faults, test_tsod_harness,
                             test_tsod_reference, test_tsod_trace)
from tsodbench.tests.conftest import _few_threads, card  # noqa: F401 (their fixtures)

for _module in (test_tsod_counts, test_tsod_faults, test_tsod_harness, test_tsod_reference,
                test_tsod_trace):
    globals().update({k: v for k, v in vars(_module).items() if k.startswith("test_")})
