"""The port's capacity planner (parallel/plan.py) and MBPol(..., plan=),
CPU float64, single device (the cases of tests/test_plan.py).

- every integer field of plan_capacities against the JAX planner's,
  analytic and exact (native counts at the water256 fixture), with
  compact_eval off and 'rebuild', in the dense and the sparse mode (the
  CPU's modes; the block layout's fields against the port's own
  tune_capacities, since the port's tiles are not the TPU's);
- MBPol(plan=plan) takes the plan's capacities and evaluates bit for bit as
  a potential tuned with tune_capacities at the same positions;
- a plan for 2 devices on a potential without a mesh, and a water-count
  mismatch, raise ValueError; CapacityPlan.apply warns DeprecationWarning and returns a new
  potential.
"""
import warnings

import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.parallel.plan import plan_capacities as j_plan
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.parallel import plan as P
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

BOX = [19.3996888399961804 / 10.0] * 3
INT_FIELDS = ('n_waters', 'n_devices', 'pair_cap', 'trip_cap', 'pair_eval_cap',
              'trip_eval_cap', 'nlist_k_max', 'nlist_kt', 'elec_pair_cap', 'disp_pair_cap')


@pytest.fixture(scope='module')
def water256():
    d = fixtures.load('water256_integration_test')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=BOX)
    _, jpos = fixtures.load_system('water256_integration_test', box=BOX)
    return tsys, np.array(jpos)


@pytest.mark.parametrize('exact', [False, True])
@pytest.mark.parametrize('ce', [None, 'rebuild'])
@pytest.mark.parametrize('mode', ['dense', 'sparse'])
def test_plan_fields_match_jax(water256, exact, ce, mode):
    _, pos = water256
    kw = dict(nonbonded_method='PME', cutoff=0.9, nlist_skin=0.05, compact_eval=ce,
              electrostatics_mode=mode)
    positions = pos if exact else None
    jp = j_plan(256, BOX, config=JConfig(**kw), positions=positions, pallas_ok=False)
    tp = P.plan_capacities(256, BOX, config=MBPolConfig(**kw), positions=positions,
                           device='cpu')
    for name in INT_FIELDS:
        assert getattr(tp, name) == getattr(jp, name), name
    assert (tp.elec_mode, tp.disp_mode, tp.pme_grid, tp.exact) == \
        (jp.elec_mode, jp.disp_mode, jp.pme_grid, jp.exact)
    assert tp.pair_eval_cap <= tp.pair_cap and tp.trip_eval_cap <= tp.trip_cap
    assert tp.mem_per_device_mb > 0 and 'eval buffers' in tp.describe()


def test_plan_block_fields_match_tune_capacities(water256):
    tsys, pos = water256
    cfg = MBPolConfig.for_dynamics(electrostatics_mode='block', dispersion_mode='pairs')
    plan = P.plan_capacities(256, BOX, config=cfg, positions=pos, device='cpu')
    tuned = MBPol(tsys, cfg, device='cpu').tune_capacities(pos)
    assert (plan.elec_mode, plan.disp_mode) == ('block', 'pairs')
    info = tuned._block_info
    np.testing.assert_array_equal(plan.site_perm, info['site_perm'])
    assert plan.tile_pair_capacity == info['tile_pair_capacity']
    assert plan.line_capacity == info['line_capacity']
    for name in ('pair_cap', 'trip_cap', 'nlist_k_max', 'nlist_kt', 'disp_pair_cap'):
        assert getattr(plan, name) == getattr(tuned, name), name
    analytic = P.plan_capacities(256, BOX, config=cfg, device='cpu')
    assert analytic.site_perm is None and analytic.tile_pair_capacity > 0


@pytest.mark.parametrize('mode', ['dense', 'sparse', 'block'])
def test_plan_constructor_equals_tuned_potential(water256, mode):
    tsys, pos = water256
    cfg = MBPolConfig.for_dynamics(electrostatics_mode=mode, compact_eval=True,
                                   scf_method='sor', target_epsilon=1e-7)
    plan = P.plan_capacities(256, BOX, config=cfg, positions=pos, device='cpu')
    pot_plan = MBPol(tsys, cfg, device='cpu', plan=plan)
    pot_tuned = MBPol(tsys, cfg, device='cpu').tune_capacities(pos)
    for name in ('pair_cap', 'trip_cap', 'pair_eval_cap', 'trip_eval_cap', 'nlist_k_max',
                 'nlist_kt', 'elec_pair_cap', 'disp_pair_cap'):
        assert getattr(pot_plan, name) == getattr(pot_tuned, name), name
    e_p, f_p, _, d_p = pot_plan.energy_forces(pos)
    e_t, f_t, _, _ = pot_tuned.energy_forces(pos)
    assert not any(bool(v) for k, v in d_p.items() if k.endswith('_overflow'))
    assert torch.equal(e_p, e_t) and torch.equal(f_p, f_t)


def test_plan_refusals(water256):
    tsys, pos = water256
    cfg = MBPolConfig.for_dynamics()
    two = P.plan_capacities(256, BOX, n_devices=2, config=cfg, device='cpu')
    with pytest.raises(ValueError, match='devices'):
        MBPol(tsys, cfg, device='cpu', plan=two)
    plan = P.plan_capacities(256, BOX, config=cfg, device='cpu')
    small = P.plan_capacities(128, BOX, config=cfg, device='cpu')
    with pytest.raises(ValueError, match='water count'):
        MBPol(tsys, cfg, device='cpu', plan=small)


def test_plan_apply_shim_deprecated(water256):
    tsys, pos = water256
    cfg = MBPolConfig(nonbonded_method='PME', cutoff=0.9, nlist_skin=0.02)
    plan = P.plan_capacities(256, BOX, config=cfg, positions=pos, device='cpu')
    pot = MBPol(tsys, cfg, device='cpu')
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        pot2 = plan.apply(pot)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert pot2 is not pot and pot2.device == pot.device
    assert pot2.pair_cap == plan.pair_cap != pot.pair_cap
