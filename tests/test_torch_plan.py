"""The port's plan refuses exactly the plans the reference refuses.

Each case builds a plan in both packages (`AssemblyPlan(...)` or
`AssemblyPlan.from_dataset` on a dataset shape) and asserts that the port
raises `PlanError` where, and only where, the reference does; where both
accept, every derived field is equal.  The walk-ladder and (contig, mer)
tag-space checks run for every plan, with or without local assembly, as in
the reference.
"""
import dataclasses
from types import SimpleNamespace

import pytest

from repro.api import AssemblyPlan as JPlan, PlanError as JPlanError
from repro.core.kmer_analysis import ExtensionPolicy as JPolicy
from repro_torch.api import AssemblyPlan, PlanError
from repro_torch.core.kmer_analysis import ExtensionPolicy

SMALL = dict(k_min=17, k_max=21, k_step=4, kmer_capacity=1 << 14,
             contig_cap=256, max_contig_len=2048, walk_capacity=1 << 15,
             link_capacity=1 << 10, max_scaffold_len=1 << 12)
CHIP = SimpleNamespace(num_reads=600_000, max_len=150)
COMMUNITY = SimpleNamespace(num_reads=240_000, max_len=150)

# (name, dataset shape or None for the constructor, args, overrides)
CASES = [
    ("slice1_chip_plan", CHIP, (21, 31, 10),
     dict(unique_rate=0.1, run_local_assembly=False, contig_cap=1 << 13,
          max_contig_len=1 << 15)),
    ("21_31_10_no_overrides", CHIP, (21, 31, 10), dict(unique_rate=0.1)),
    ("21_31_10_no_local_assembly", CHIP, (21, 31, 10),
     dict(unique_rate=0.1, run_local_assembly=False)),
    ("17_21_4_contig_cap_8192", CHIP, (17, 21, 4),
     dict(unique_rate=0.1, contig_cap=8192)),
    ("17_21_4_no_overrides", CHIP, (17, 21, 4), dict(unique_rate=0.1)),
    ("chip_community_contig_rounds", COMMUNITY, (17, 21, 4),
     dict(unique_rate=0.1, run_local_assembly=False)),
    ("chip_community_assemble", COMMUNITY, (17, 21, 4),
     dict(unique_rate=0.1)),
    ("17_21_4_cap_4096", COMMUNITY, (17, 21, 4), dict(contig_cap=4096)),
    ("17_21_4_cap_4097", COMMUNITY, (17, 21, 4), dict(contig_cap=4097)),
    ("13_25_4", COMMUNITY, (13, 25, 4), dict(unique_rate=0.1)),
    ("11_15_4_bottom_rung", COMMUNITY, (11, 15, 4), dict()),
    ("17_21_4_ladder_step_6", COMMUNITY, (17, 21, 4),
     dict(walk_ladder_step=6)),
    ("small_plan", None, (), dict(SMALL)),
    ("small_plan_no_local_assembly", None, (),
     dict(SMALL, run_local_assembly=False)),
    ("small_plan_k_29", None, (), dict(SMALL, k_min=21, k_max=29)),
    ("small_plan_even_k", None, (), dict(SMALL, k_min=18, k_max=22)),
]


def _build(Plan, Policy, shape, args, overrides):
    kw = dict(overrides)
    if shape is None:
        return Plan(policy=Policy(err_rate=0.05), **kw)
    return Plan.from_dataset(shape, args, **kw)


def _outcome(Plan, Policy, Error, case):
    _, shape, args, overrides = case
    try:
        return _build(Plan, Policy, shape, args, overrides), None
    except Error as e:
        return None, str(e)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plan_refused_exactly_where_the_reference_refuses(case):
    jplan, jerr = _outcome(JPlan, JPolicy, JPlanError, case)
    plan, err = _outcome(AssemblyPlan, ExtensionPolicy, PlanError, case)
    assert (err is None) == (jerr is None), (err, jerr)
    if err is None:
        want = dataclasses.asdict(jplan)
        got = dataclasses.asdict(plan)
        for key in ("policy", "kernel_backend"):
            want.pop(key), got.pop(key)
        assert got == want
    else:
        assert err == jerr


def test_known_refusals():
    """The cases the plan repair is about: the slice-1 chip plan and its
    ladder are refused, the tag space caps contig_cap at 4096."""
    refused = {c[0] for c in CASES
               if _outcome(AssemblyPlan, ExtensionPolicy, PlanError, c)[1]}
    assert {"slice1_chip_plan", "21_31_10_no_overrides",
            "17_21_4_contig_cap_8192", "17_21_4_cap_4097",
            "small_plan_even_k"} <= refused
    plan, _ = _outcome(AssemblyPlan, ExtensionPolicy, PlanError, CASES[5])
    assert plan.contig_cap == 4096 and not plan.run_local_assembly


# (preset, overrides as a function of the package's ExtensionPolicy)
PRESETS = [
    ("small_community_plan", lambda Policy: {}),
    ("small_community_plan", lambda Policy: dict(
        kmer_capacity=1 << 16, run_local_assembly=True, contig_cap=512)),
    ("quality_plan", lambda Policy: {}),
    ("quality_plan", lambda Policy: dict(
        link_capacity=1 << 12, walk_capacity=1 << 17,
        policy=Policy(min_ext=3))),
]


@pytest.mark.parametrize("name,overrides", PRESETS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(PRESETS)])
def test_assembly_presets_equal_reference(name, overrides):
    """`configs.assembly_presets` builds the reference's plans, field for
    field, with and without overrides."""
    from repro.configs import assembly_presets as jpresets
    from repro_torch.configs import assembly_presets as presets

    jplan = getattr(jpresets, name)(**overrides(JPolicy))
    plan = getattr(presets, name)(**overrides(ExtensionPolicy))
    assert isinstance(plan, AssemblyPlan)
    assert isinstance(plan.policy, ExtensionPolicy)
    assert tuple(plan.policy) == tuple(jplan.policy)
    want = dataclasses.asdict(jplan)
    got = dataclasses.asdict(plan)
    for key in ("policy", "kernel_backend"):
        want.pop(key), got.pop(key)
    assert got == want
