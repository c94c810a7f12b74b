"""The port's CEL device-selector evaluator
(`karpenter_tpu_torch.scheduling.dynamicresources.cel`) against the
reference's, on the CPU.

Every case of the reference's `tests/test_dra_cel.py` runs twice, as it is
and as the port's twin, from the same module state, with every CEL,
selector and allocator call recorded (`test_torch_dra.recording`): the
records must be equal and the reference's assertions must hold in the twin.
Then a corpus of expressions (every CEL expression the reference's DRA tests
write, and malformed and ill-typed variants of them) is evaluated on both
packages over a set of devices: each verdict, and each error's class name
and message, must be equal (`CelError` and `_Missing` keep their names and
messages). Both parse caches start empty and see the same expressions in
the same order, so a sticky compile error is held too. Tolerance: exact.
"""

from __future__ import annotations

import re

import pytest

from test_torch_dra import REF, PORT, TESTS, assert_twin_case, reference_cases, same_start

CEL_CASES = reference_cases("test_dra_cel")


@pytest.mark.parametrize("case", CEL_CASES)
def test_reference_cel_case_matches(case):
    assert_twin_case("test_dra_cel", case)


def corpus() -> list[str]:
    """Every string literal that reads as a CEL expression in the reference's
    DRA tests, plus broken and ill-typed variants of some of them."""
    found = []
    for name in ("test_dra_cel", "test_dra", "test_dra_depth", "test_dra_superposition"):
        src = (TESTS / f"{name}.py").read_text()
        for m in re.finditer(r"""(['"])((?:device\.|has\(|!|size\()(?:(?!\1).)*)\1""", src):
            found.append(m.group(2).encode().decode("unicode_escape"))
    exprs = list(dict.fromkeys(found))
    extra = [e + " &&" for e in exprs[:8]] + [e.replace("==", "<") for e in exprs[:8]]
    extra += ["", "device.driver ==", 'device.attributes["d"].count + 1 == 2', "true", "1 == 1.0", '"a" in ["a"]',
              'device.capacity["gpu.example.com"].memory.compareTo(quantity("1Gi")) > 0', "device.nope", "((true)",
              'quantity("x") == 1', 'device.attributes["gpu.example.com"].model.matches("[")']
    return exprs + extra


def devices(pkg: str) -> list:
    import importlib

    K = importlib.import_module(f"{pkg}.kube")
    res = importlib.import_module(f"{pkg}.utils.resources")
    return [
        K.Device(name="g0", attributes={"gpu.example.com/model": "h100", "gpu.example.com/type": "compute"},
                 capacity=res.parse_resource_list({"memory": "40Gi"})),
        K.Device(name="g1", attributes={"gpu.example.com/model": "H100-sxm", "gpu.example.com/ecc": True,
                                        "nic.example.com/ports": 8}, capacity=res.parse_resource_list({"memory": "80Gi"})),
        K.Device(name="n", attributes={"speed": "fast", "d/count": 3, "d/flag": False, "d/sep": "\n",
                                       "nic.example.com/temp": -3, "nic.example.com/ports": "8"}),
        K.Device(name="bare"),
    ]


def verdicts(pkg: str, exprs: list[str]) -> list:
    import importlib

    cel = importlib.import_module(f"{pkg}.scheduling.dynamicresources.cel")
    same_start(pkg)
    out = []
    for d in devices(pkg):
        for driver in ("", "gpu.example.com", "nic.example.com"):
            for e in exprs:
                try:
                    out.append(("ok", cel.evaluate(e, d, driver)))
                except Exception as err:  # the class name and message are what is compared
                    out.append(("raise", type(err).__name__, [c.__name__ for c in type(err).__mro__[:3]], str(err)))
                out.append(("match", cel.matches_device(e, d, driver)))
    return out


def test_corpus_verdicts_and_errors_match_reference():
    exprs = corpus()
    assert len(exprs) > 60
    want = verdicts(REF, exprs)
    got = verdicts(PORT, exprs)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, (k, exprs[(k // 2) % len(exprs)])
    kinds = {w[1] for w in want if w[0] == "raise"}
    assert {"CelError", "_Missing"} <= kinds, kinds
    assert any(w == ("ok", True) for w in want) and any(w == ("ok", False) for w in want)


def test_parse_cache_is_the_ports_own():
    """The port keeps its own parse cache, with the reference's bound."""
    import karpenter_tpu.scheduling.dynamicresources.cel as ref_cel
    import karpenter_tpu_torch.scheduling.dynamicresources.cel as port_cel

    same_start(PORT)
    port_cel.matches_device("device.driver ==", devices(PORT)[0])
    assert "device.driver ==" in port_cel._cache and "device.driver ==" not in ref_cel._cache
    assert isinstance(port_cel._cache["device.driver =="], port_cel.CelError)
    assert port_cel._CACHE_MAX == ref_cel._CACHE_MAX
