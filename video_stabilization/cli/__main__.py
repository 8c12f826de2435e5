from video_stabilization.cli.app import main

raise SystemExit(main())
