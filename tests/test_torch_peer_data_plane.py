"""The port's peer data plane against the JAX package's:
``tests/test_peer_data_plane.py`` (the listener, signed tickets, peer
ships and their fault ladder, endpoint discovery, partial import
failures, retry jitter, the meta size guard) runs again with every
JAX-package name bound to the port's, through
``test_torch_fleet.ported`` (see that module's docstring)."""
import test_peer_data_plane
from test_torch_fleet import _one_torch_thread, export  # noqa: F401

PORT = export(test_peer_data_plane, globals())
