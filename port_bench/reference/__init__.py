"""The benchmark's plain reference of MB-pol water in a periodic box.

A frozen, self-contained copy of the MB-pol formulas in plain PyTorch: the
Partridge-Schwenke one-body term, the 2B/3B permutationally invariant
polynomials in their monomial expansion, TT6 dispersion with the C2 switch,
and the Thole-damped polarizable PME electrostatics with geometry-dependent
charges, solved to a tight tolerance. It reads its own copy of the constant
tables (`data/`), builds its own lists, dipoles and PME grids from the
positions and the box, and imports nothing of the program under test.
"""
