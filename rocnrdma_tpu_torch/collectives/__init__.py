"""Collectives: the ring world and the cross-slice allreduce shim."""
