"""Minimal simtk.unit-style quantities (a copy of mbpol_openmm_plugin_tpu/app/units_compat.py).

Just enough unit algebra for the reference's driver scripts: Quantity =
value x Unit, with units represented by their conversion factor into the
framework's internal system (nm / ps / kJ/mol / K / bar / amu / e).
"""
from __future__ import annotations

import numpy as np


class Unit:
    def __init__(self, factor, name):
        self.factor = factor
        self.name = name

    def __mul__(self, other):
        if isinstance(other, Unit):
            return Unit(self.factor * other.factor, f'{self.name}*{other.name}')
        return Quantity(other, self)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Unit(self.factor / other.factor, f'{self.name}/{other.name}')
        return Unit(self.factor / other, self.name)

    def __rtruediv__(self, other):
        # e.g. 1.0 / unit.picoseconds
        return Quantity(other, Unit(1.0 / self.factor, f'1/{self.name}'))

    def __pow__(self, n):
        return Unit(self.factor ** n, f'{self.name}**{n}')


class Quantity:
    def __init__(self, value, unit):
        self.value = value
        self.unit = unit

    @property
    def _value(self):
        return self.value

    def value_in_unit(self, unit):
        return _as_array_or_scalar(np.asarray(self.value) * (self.unit.factor / unit.factor))

    def in_units_of(self, unit):
        return Quantity(self.value_in_unit(unit), unit)

    def to_internal(self):
        """Value in framework internal units (nm/ps/kJ/mol/...)."""
        return _as_array_or_scalar(np.asarray(self.value) * self.unit.factor)

    def __mul__(self, other):
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit * other)
        return Quantity(np.asarray(self.value) * other, self.unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit / other)
        return Quantity(np.asarray(self.value) / other, self.unit)

    def __float__(self):
        return float(self.to_internal())

    def __iter__(self):
        for v in np.asarray(self.value):
            yield Quantity(v, self.unit)

    def __getitem__(self, i):
        return Quantity(np.asarray(self.value)[i], self.unit)

    def __repr__(self):
        return f'Quantity({self.value!r}, {self.unit.name})'


def _as_array_or_scalar(a):
    return a.item() if np.ndim(a) == 0 else a


def to_internal(x, default_unit=None):
    """Accept Quantity or raw number; return value in internal units."""
    if isinstance(x, Quantity):
        return x.to_internal()
    if default_unit is not None and x is not None:
        return np.asarray(x) * default_unit.factor
    return x


# length (internal: nm)
nanometer = nanometers = Unit(1.0, 'nm')
angstrom = angstroms = Unit(0.1, 'A')
# time (internal: ps)
picosecond = picoseconds = Unit(1.0, 'ps')
femtosecond = femtoseconds = Unit(1e-3, 'fs')
nanosecond = nanoseconds = Unit(1e3, 'ns')
# energy (internal: kJ/mol)
kilojoule_per_mole = kilojoules_per_mole = Unit(1.0, 'kJ/mol')
kilocalorie_per_mole = kilocalories_per_mole = Unit(4.184, 'kcal/mol')
# temperature
kelvin = Unit(1.0, 'K')
# pressure (internal: bar)
bar = Unit(1.0, 'bar')
atmosphere = atmospheres = Unit(1.01325, 'atm')
# mass / charge
amu = dalton = daltons = Unit(1.0, 'amu')
elementary_charge = Unit(1.0, 'e')
# speed
nanometer_per_picosecond = Unit(1.0, 'nm/ps')
