"""Scale-out across nodes (``multihost``); the mesh is ROADMAP.md §1
item 7."""
