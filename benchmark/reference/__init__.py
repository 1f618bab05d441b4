"""The plain reference that judges the program: AES-128, LWE and the
comparison.  numpy only; it imports nothing of the program."""
