"""The plain reference the benchmark judges the program by.

NumPy only: it imports nothing of the program under test, and nothing
that the program made (weights, planes or tables) reaches it. It works
out selector matches, override windows, ``used`` and the verdicts of
both throttle kinds again from the plain cluster data the traffic
generator produced.
"""
