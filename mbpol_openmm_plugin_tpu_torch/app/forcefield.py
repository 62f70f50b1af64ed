"""ForceField: parses the reference's mbpol.xml format into a SystemSpec
(port of mbpol_openmm_plugin_tpu/app/forcefield.py).

Supports the canonical python/mbpol.xml plus its variants
(mbpol_no_custom_dispersion_no_charge_redistribution.xml): AtomTypes,
HOH/Cl Residues with the average3 virtual site, the four MBPol*Force
elements (Thole attributes, per-type charge/damping/polarizability, 2b/3b
cutoffs), the <setIncludeChargeRedistribution> toggle, and the embedded
dispersion <Script> (the C6/d6 class tables are extracted from the script
text rather than executing it).

createSystem returns a `SystemSpec` that mimics the force-list surface of an
OpenMM System (getNumForces/removeForce/addForce) so the reference's
force-isolation test pattern works unchanged
(python/tests/TestReferenceMBPolTwoBodyForce.py:28-39).
"""
from __future__ import annotations

import dataclasses
import os
import re
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np

from mbpol_openmm_plugin_tpu_torch.app import units_compat as unit
from mbpol_openmm_plugin_tpu_torch.system import System

FLOAT_RE = r'[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?'

# nonbonded method tags
NoCutoff = 'NoCutoff'
PME = 'PME'
CutoffPeriodic = 'CutoffPeriodic'
CutoffNonPeriodic = 'CutoffNonPeriodic'


def mbpol_xml_path():
    """Path of the port's packaged parameter file (byte for byte the JAX
    package's copy, which tools/emit_xml.py regenerates from the extracted
    tables; numerically identical to the reference's python/mbpol.xml)."""
    return os.path.join(os.path.dirname(__file__), 'mbpol.xml')


class _Force:
    """Tag object in the SystemSpec force list (reference force order:
    elec, one, two, three, CMMotionRemover, CustomDispersion)."""

    def __init__(self, kind, **params):
        self.kind = kind
        self.params = params

    def __repr__(self):
        return f'<Force {self.kind}>'


@dataclasses.dataclass
class SystemSpec:
    system: System
    forces: List[_Force]
    nonbonded_method: str
    cutoff: float
    ewald_error_tolerance: float
    thole: Optional[np.ndarray]
    include_charge_redistribution: bool
    cutoff_2b: float
    cutoff_3b: float

    def getNumForces(self):
        return len(self.forces)

    def getForce(self, i):
        return self.forces[i]

    def removeForce(self, i):
        self.forces.pop(i)

    def addForce(self, force):
        self.forces.append(force)
        return len(self.forces) - 1

    @property
    def term_names(self):
        mapping = dict(electrostatics='electrostatics', one_body='one_body',
                       two_body='two_body', three_body='three_body',
                       dispersion='dispersion')
        return tuple(mapping[f.kind] for f in self.forces if f.kind in mapping)

    def find_forces(self, kind):
        return [f for f in self.forces if f.kind == kind]


class ForceField:
    def __init__(self, *files):
        self.has_electrostatics = False
        self.has_one_body = False
        self.has_two_body = False
        self.has_three_body = False
        self.has_dispersion = False
        self.include_charge_redistribution = True
        self.thole = None
        self.cutoff_2b = 0.65
        self.cutoff_3b = 0.45
        self.C6 = None
        self.d6 = None
        for f in files:
            self._parse(f)

    def _parse(self, path):
        with open(path) as fh:
            text = fh.read()
        root = ET.fromstring(text)

        e = root.find('MBPolElectrostaticsForce')
        if e is not None:
            self.has_electrostatics = True
            if 'thole-charge-charge' in e.attrib:
                # order: TCC, TCD, TDD, TDDOH, TDDHH (mbpol.py:266)
                self.thole = np.array([
                    float(e.attrib['thole-charge-charge']),
                    float(e.attrib['thole-charge-dipole']),
                    float(e.attrib['thole-dipole-dipole']),
                    float(e.attrib['thole-dipole-dipole-singlebond']),
                    float(e.attrib['thole-dipole-dipole']),
                ])
            else:
                # Older per-Residue dialect used by the reference's shipped
                # variant file (mbpol_no_custom_dispersion_no_charge_
                # redistribution.xml:31): five explicitly-named attributes
                # on the water <Residue> row.
                for res in e.findall('Residue'):
                    if 'thole-charge-charge' in res.attrib:
                        self.thole = np.array([
                            float(res.attrib['thole-charge-charge']),
                            float(res.attrib['thole-charge-dipole']),
                            float(res.attrib['thole-dipole-dipole-intermolecules']),
                            float(res.attrib['thole-dipole-dipole-OH']),
                            float(res.attrib['thole-dipole-dipole-HH']),
                        ])
                        break
            toggle = e.find('setIncludeChargeRedistribution')
            if toggle is not None:
                self.include_charge_redistribution = \
                    toggle.attrib.get('chargeRedistribution', 'True').lower() == 'true'
        if root.find('MBPolOneBodyForce') is not None:
            self.has_one_body = True
        t = root.find('MBPolTwoBodyForce')
        if t is not None:
            self.has_two_body = True
            if 'cutoff_nm' in t.attrib:
                self.cutoff_2b = float(t.attrib['cutoff_nm'])
        t = root.find('MBPolThreeBodyForce')
        if t is not None:
            self.has_three_body = True
            if 'cutoff_nm' in t.attrib:
                self.cutoff_3b = float(t.attrib['cutoff_nm'])

        script = root.find('Script')
        if script is not None and 'C6table' in (script.text or ''):
            self.has_dispersion = True
            self.C6 = self._parse_table(script.text, 'C6table')
            self.d6 = self._parse_table(script.text, 'd6table')

    @staticmethod
    def _parse_table(text, name):
        m = re.search(r'%s\s*=\s*\[(.*?)\]' % name, text, re.S)
        body = re.sub(r'#[^\n]*', '', m.group(1))
        vals = [float(v) for v in re.findall(FLOAT_RE, body)]
        return np.asarray(vals).reshape(4, 4)

    # ------------------------------------------------------------------
    def createSystem(self, topology, nonbondedMethod=NoCutoff,
                     nonbondedCutoff=1.0 * unit.nanometer,
                     ewaldErrorTolerance=1e-4, hydrogenMass=None,
                     isotope='H2O', removeCMMotion=True, **kwargs):
        if nonbondedMethod == CutoffPeriodic and self.has_electrostatics:
            # Reference parity: the electrostatics generator's methodMap has
            # no CutoffPeriodic entry and raises (reference python/mbpol.py:
            # 291-296) - cluster electrostatics applies no minimum imaging,
            # so silently accepting it would mix non-imaged electrostatics
            # with imaged 2b/3b terms.
            raise ValueError(
                'CutoffPeriodic is not a valid nonbonded method for MB-pol '
                'electrostatics; use PME for periodic systems')
        box = topology.getUnitCellDimensions()
        periodic = nonbondedMethod in (PME, CutoffPeriodic)
        # true isotopologues (total mass changes; the PES is
        # mass-independent, so only the masses differ) delegate to
        # System.waters(isotope=...) via from_atom_names
        if isotope != 'H2O' and hydrogenMass is not None:
            raise ValueError('isotope= and hydrogenMass= are mutually '
                             'exclusive (HMR conserves the molecular '
                             'mass; isotopes change it)')
        sys_ = System.from_atom_names(topology.atom_names, topology.residue_names,
                                      box=box if periodic else None,
                                      isotope=isotope)
        if hydrogenMass is not None:
            # OpenMM createSystem semantics (hydrogen mass repartitioning):
            # set every H to this mass and subtract the difference from the
            # bonded heavy atom (the water O) so the molecular mass is
            # unchanged. For TRUE isotopologues (total mass changes) use
            # System.waters(isotope='D2O'|'HDO') instead.
            h_mass = (hydrogenMass.value_in_unit(unit.amu)
                      if hasattr(hydrogenMass, 'value_in_unit')
                      else float(hydrogenMass))
            masses = np.array(sys_.masses)
            for h_idx in (sys_.h1_index, sys_.h2_index):
                masses[sys_.o_index] -= h_mass - masses[h_idx]
                masses[h_idx] = h_mass
            if np.any(masses[sys_.o_index] <= 0):
                raise ValueError(f'hydrogenMass={h_mass} amu leaves the '
                                 'oxygen with non-positive mass')
            sys_ = dataclasses.replace(sys_, masses=masses)
        if self.has_electrostatics and sys_.n_ions:
            # fail at createSystem, not when the potential is first built:
            # mbpol.xml:22-27 defines electrostatics parameters for water
            # only (ions appear only in the dispersion tables), so the full
            # force field cannot cover an ion-containing topology - use the
            # dispersion-only customdispersion.xml, or a ForceField whose
            # electrostatics generator is absent, for water+ion systems
            raise ValueError(
                f'topology contains {sys_.n_ions} ion(s) but the MB-pol '
                'force field defines electrostatics parameters for water '
                'only (mbpol.xml:22-27); use customdispersion.xml or '
                'remove the ion')
        forces = []
        if self.has_electrostatics:
            forces.append(_Force('electrostatics'))
        if self.has_one_body:
            forces.append(_Force('one_body'))
        if self.has_two_body:
            forces.append(_Force('two_body'))
        if self.has_three_body:
            forces.append(_Force('three_body'))
        if removeCMMotion:
            # OpenMM createSystem default: a CMMotionRemover in the force
            # list (reference force order, TestReferenceMBPolTwoBodyForce
            # .py:28-39); the app Simulation maps the tag to
            # SimulationConfig.cm_motion_interval=1
            forces.append(_Force('cm_motion'))
        if self.has_dispersion:
            forces.append(_Force('dispersion'))

        return SystemSpec(
            system=sys_, forces=forces,
            nonbonded_method='PME' if nonbondedMethod == PME else 'NoCutoff',
            cutoff=float(unit.to_internal(nonbondedCutoff, unit.nanometer)),
            ewald_error_tolerance=float(ewaldErrorTolerance),
            thole=self.thole,
            include_charge_redistribution=self.include_charge_redistribution,
            cutoff_2b=self.cutoff_2b, cutoff_3b=self.cutoff_3b)
