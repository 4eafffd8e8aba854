"""Distribution of the port: the sharding plans, single-device part
(``plan``); the mesh, collectives and the dry run come later."""
