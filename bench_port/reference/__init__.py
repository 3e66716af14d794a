"""The plain fp32 reference models and the seeded weights both sides are given."""
