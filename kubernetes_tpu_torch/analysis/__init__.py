"""Runtime hazard checks the port's host modules share: ``lockcheck``, the
lock-order checker armed by ``GRAFT_LOCKCHECK=1``."""
