"""``python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``"""
import sys

if __name__ == "__main__":
    from portbench.run import main

    sys.exit(main())
