"""The example applications of the port, one module per script of the
repository's examples/ directory, under the same names.

Each module has a `main(argv=None)` with the script's arguments and
defaults, plus `--device` (default the card; `--device cpu` runs float64 on
the CPU), and a function that returns what the script prints as a dict:

    python -m mbpol_openmm_plugin_tpu_torch.examples.bulk_properties 400
    python -m mbpol_openmm_plugin_tpu_torch.examples.ir_spectrum 200 --device cpu

The inputs come from tests/fixtures/*.npz; the app-layer examples read the
PDBs that `make_inputs` writes from them (into this directory, on demand).
"""
