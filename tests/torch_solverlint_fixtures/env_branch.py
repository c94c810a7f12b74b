"""solverlint fixture for the port: env-dependent-branch. Never imported —
parsed only.

Seeds unregistered os.environ reads through every access shape (get,
subscript, getenv, membership, bulk read) and the alias import pattern.
Knobs the port registers (it reads them) and the pragma'd twin must NOT be
flagged.
"""

import os
import os as sneaky_os
from os import environ, getenv


def bad_unregistered_get():
    return os.environ.get("KARPENTER_SOLVER_SECRET", "")


def bad_aliased_module():
    # a renamed module import must not evade the knob table
    return sneaky_os.environ.get("SOLVER_EXPERIMENT", "")


def bad_from_import_environ():
    return environ["SOLVER_FORK_BEHAVIOR"]


def bad_from_import_getenv():
    return getenv("SOLVER_TUNING")


def bad_subscript():
    return os.environ["UNREVIEWED_KNOB"]


def bad_membership():
    return "SOLVER_FAST_PATH" in os.environ


def bad_dynamic_key(name):
    return os.environ.get(f"KARPENTER_{name}")


def bad_bulk_read():
    return dict(os.environ.items())


def ok_registered():
    a = os.environ.get("KARPENTER_SOLVER_MULTIGROUP", "")
    b = os.getenv("KARPENTER_SOLVER_BUCKET")
    c = "KARPENTER_SOLVER_DETCHECK" in os.environ
    return a, b, c


def ok_pragma():
    return os.environ.get("KARPENTER_SOLVER_SECRET", "")  # solverlint: ok(env-dependent-branch): fixture — proves the pragma form suppresses
