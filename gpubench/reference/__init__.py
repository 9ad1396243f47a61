"""The plain reference the benchmark's comparison holds the program to. It
imports torch only: nothing of the program under test."""
