"""The port's fleet-global prefix cache against the JAX package's:
``tests/test_fleet_prefix.py`` (chain hashes, the digest, the engine's
prefix export and import, prefix affinity, proactive ships, the
coherence storm) runs again with every JAX-package name bound to the
port's, through ``test_torch_fleet.ported`` (see that module's
docstring)."""
import test_fleet_prefix
from test_torch_fleet import _one_torch_thread, export  # noqa: F401

PORT = export(test_fleet_prefix, globals())
