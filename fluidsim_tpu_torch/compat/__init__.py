"""Bit-exact reproduction of the reference's seeding (std::mt19937 and UniformPointScatter)."""
