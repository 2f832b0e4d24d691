"""Process groups: bootstrap, the collectives of a mesh axis, the local
rank spawner."""
