import pytest

from benchmark.tests.tiny import shrink


@pytest.fixture(autouse=True, scope="session")
def _small_drivers():
    shrink()
