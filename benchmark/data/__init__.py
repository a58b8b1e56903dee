"""Input generators, on the device from the seed. They import nothing of
the program, so the reference can make the same inputs again."""
