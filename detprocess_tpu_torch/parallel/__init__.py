"""Scale-out: the device mesh and its collectives (``collectives``,
``mesh``) and the mesh over processes (``multihost``)."""
