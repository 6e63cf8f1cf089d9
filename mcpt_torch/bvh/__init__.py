"""Acceleration structures: the Karras LBVH, treelet restructuring and the
clustered two-level BVH the hybrid engine walks."""
