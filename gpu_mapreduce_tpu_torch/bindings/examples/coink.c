/* coink — drive the OINK script interpreter from C (the counterpart of
 * the reference's oink/library.h mrmpi_open/_file/_command/_close).
 *
 * Usage: coink [-device cpu|cuda] script.oink [logfile]
 * Every MR of the script lives on the card unless -device names another
 * device (oink/script.py's -device).  Without a card it exits 1.
 */

#include <stdio.h>
#include <string.h>

#include "../cmapreduce.h"

int main(int argc, char **argv) {
  const char *device = NULL; /* the card */
  if (argc > 2 && strcmp(argv[1], "-device") == 0) {
    device = argv[2];
    argc -= 2;
    argv += 2;
  }
  if (argc < 2) {
    fprintf(stderr, "usage: coink [-device cpu|cuda] script.oink "
                    "[logfile]\n");
    return 1;
  }
  if (MR_init() != 0) {
    fprintf(stderr, "MR_init failed: %s\n", MR_last_error());
    return 1;
  }
  void *oink = OINK_open_device(argc > 2 ? argv[2] : NULL, device);
  if (oink == NULL) {
    fprintf(stderr, "OINK_open failed: %s\n", MR_last_error());
    MR_finalize();
    return 1;
  }
  int rc = OINK_file(oink, argv[1]);
  if (rc != 0) fprintf(stderr, "script error: %s\n", MR_last_error());
  OINK_close(oink);
  MR_finalize();
  return rc == 0 ? 0 : 1;
}
