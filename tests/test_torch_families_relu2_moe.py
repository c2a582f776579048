"""The tests of ``tests/test_torch_families.py`` on Nemotron-4-15B (the
squared-ReLU MLP) and DeepSeek-MoE-16B (fine-grained experts beside two
shared ones), each at its SMOKE width on bit-plane device KV: the same
tests, collected here with this module's ``case`` fixture (that file's
docstring gives the bounds; DeepSeek may part from the reference only at
an exact bf16 logit tie, and Nemotron's plain forward is compared with
XLA's rsqrt and q/k/v projections supplied, ``XLA_PROJECTIONS``; every
case is held to the common bound)."""

import pytest

import test_torch_families as F
from test_torch_families import (  # noqa: F401  the tests and fixtures, run on these cases
    prefilled,
    served,
    test_device_bytes_are_the_controllers_plane_scaled_reads,
    test_each_layer_matches_reference_given_its_rsqrt,
    test_greedy_tokens_equal,
    test_plain_forward_matches_reference,
    test_prefill_logits_and_cache_match_reference,
    test_report_counters_equal,
    test_teacher_forced_bitplane_decode_logits,
    test_teacher_forced_decode_logits,
)


@pytest.fixture(scope="module", params=["nemotron-4-15b", "deepseek-moe-16b"])
def case(request):
    return F.make_case(request.param)
