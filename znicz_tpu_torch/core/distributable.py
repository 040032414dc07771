"""The IDistributable protocol.

Counterpart of ``znicz_tpu/core/distributable.py``: the master-slave
data-parallel contract's methods, each a no-op by default.  The GD
units implement the gradient protocol (``units/nn_units.py``); units
that declare the protocol (``GDLSTMScan``) keep these defaults or
override the subset they need.  The port's multi-process training is
SPMD over a mesh (``parallel/mesh.py``), as JAX's is.
"""


class IDistributable(object):
    """Units override the subset they need; defaults are no-ops."""

    negotiates_on_connect = False

    def generate_data_for_master(self):
        return None

    def generate_data_for_slave(self, slave=None):
        return None

    def apply_data_from_master(self, data):
        pass

    def apply_data_from_slave(self, data, slave=None):
        pass

    def drop_slave(self, slave=None):
        pass


class TriviallyDistributable(IDistributable):
    """Stateless under distribution."""
