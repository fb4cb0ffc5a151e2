"""Test configuration: force an 8-device virtual CPU platform so sharding
paths are exercised without an accelerator.

Set ``IDIAPTTS_TEST_PLATFORM=gpu`` to run the suite on an NVIDIA GPU
instead; tests marked ``gpu`` (compiled kernels, which have no CPU
path) run only there and skip elsewhere."""

import os

_platform = os.environ.get("IDIAPTTS_TEST_PLATFORM", "cpu")
if _platform not in ("cpu", "gpu"):
    raise ValueError("IDIAPTTS_TEST_PLATFORM must be cpu or gpu, not "
                     + repr(_platform))
os.environ["JAX_PLATFORMS"] = _platform
if _platform == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

# jax may already be imported by a pytest plugin, in which case it captured
# JAX_PLATFORMS/XLA_FLAGS at import time — override through the config API
# (must happen before the backend is initialised).
import jax  # noqa: E402

jax.config.update("jax_platforms", _platform)

import pytest  # noqa: E402

# Repo-local fixture corpus (committed; regenerate with
# tools/create_fixtures.py). The suite is self-contained: it runs without
# the read-only reference mount.
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

# Reference fixture set — only for parity tests that compare against the
# reference's precomputed outputs (pyworld/SPTK/Merlin artefacts). These
# skip when the mount is absent.
REF_FIXTURES = "/root/reference/test/integration/fixtures"

QUESTION_FILE = "questions-gen_dnn.hed"


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX runs on a GPU (decided
    per test, never at import, so every worker collects the same
    tests)."""
    if request.node.get_closest_marker("gpu") \
            and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (IDIAPTTS_TEST_PLATFORM=gpu)")


@pytest.fixture(scope="session")
def fixtures_dir():
    if not os.path.isdir(FIXTURES):
        pytest.skip("run tools/create_fixtures.py to generate fixtures")
    return FIXTURES


@pytest.fixture(scope="session")
def ref_fixtures_dir():
    if not os.path.isdir(REF_FIXTURES):
        pytest.skip("reference fixtures not available")
    return REF_FIXTURES


@pytest.fixture(scope="session")
def id_list(fixtures_dir):
    with open(os.path.join(fixtures_dir, "file_id_list.txt")) as f:
        return [line.strip() for line in f if line.strip()]


@pytest.fixture(scope="session")
def uid(id_list):
    return id_list[0]


@pytest.fixture(scope="session")
def question_file(fixtures_dir):
    return os.path.join(fixtures_dir, QUESTION_FILE)


@pytest.fixture(scope="session")
def num_questions(question_file):
    """Question-vector width incl. the 9 subphone features."""
    from idiaptts_tpu.data.questions import QuestionSet
    return QuestionSet(question_file).dict_size + 9
